"""The plain reference of the benchmark's configurations: RecNet's decoder
and reconstructors, losses and Adam in plain PyTorch float32 (TF32 off),
importing nothing of the program. ``recnet`` holds the model, ``train``
the reference's first train steps, ``decode`` the logits along served
tokens."""
