"""The LM stack: layers, attention (with the flash route through K8), the
dense decoder-only Transformer and its step functions."""
