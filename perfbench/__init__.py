"""The benchmark of `avsi_torch` on one NVIDIA H100 (`python3 perfbench/run.py`).

Everything here is the yardstick: traffic generation, the weights drawn
from the seed, the reduction of device traces and counters to metrics,
the peaks, the operation and byte counts, and the plain reference that
decides `correct`.  From the port it takes only the system under test and
its counters and kernel names.
"""
