"""The plain reference: a straightforward count, model build, query and
database reader in PyTorch and numpy.  It imports nothing of the program."""
