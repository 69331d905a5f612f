"""The plain reference: the benchmark's own copy of the configurations'
models, loss and optimizer in plain PyTorch, importing nothing of the
program."""
