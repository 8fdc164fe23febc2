"""The flash kernel: blocked online-softmax attention, forward in CUDA."""
