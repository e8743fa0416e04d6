"""Model operations of the utterances trained in the window over the
window's seconds, as a share of the H100's float32 peak (67 TFLOP/s).
Operations per utterance: the configuration's reference module
(`train_flops`: forward and backward from shapes, 2 per multiply-add,
each STFT at an FFT's 5 N log2 N, element-wise work left out)."""

from perfbench.lib.roofline import PEAK_FLOPS


def read(layer: dict, run):
    if not layer.get("window_s"):
        return None
    rate = layer["flops_per_utt"] * layer["utterances"] / layer["window_s"]
    return 100.0 * rate / PEAK_FLOPS["float32"]
