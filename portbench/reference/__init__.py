"""The plain reference: CaffeNet-style nets and serialized graphs trained
through the τ-averaging rounds in plain PyTorch, from the benchmark's
weights and rows. It imports nothing of the port."""
