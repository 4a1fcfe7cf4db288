"""repro_torch.launch — command-line launchers of the port."""
