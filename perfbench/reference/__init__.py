"""The plain reference that decides `correct`: plain PyTorch on the
benchmark's own inputs and weights, float32 with TF32 off.  It imports
neither JAX nor the JAX package nor anything of `avsi_torch`; where it
follows the port's arithmetic it is a frozen copy, named in each file."""
