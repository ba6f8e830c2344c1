"""Decoder ops on tensors: attention and RNN cells (plain PyTorch), and the
hand-written CUDA decode kernels under ``ops.cuda``."""
