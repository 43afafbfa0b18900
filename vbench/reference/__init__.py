"""The plain reference the check holds the port to: the Gibbs resample
(`gibbs`), its noise (`philox`) and the count rebuild (`counts`), in plain
PyTorch, importing nothing of the program."""
