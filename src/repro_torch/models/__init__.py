"""`repro_torch.models`: the decoder-only LM (dense and vlm families)."""
