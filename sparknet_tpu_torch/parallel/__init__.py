"""Data-parallel training over a torch.distributed group."""
