"""`repro_torch.serve`: the port's serving layer (`serve.lookup`)."""
