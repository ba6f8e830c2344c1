"""Models: the attention-RNN caption decoder."""
