"""The model layer: the GPT-class LM's serving path (forward, loss,
KV-cached generation) on PyTorch, with attention through the hand-written
flash kernel."""
