"""The plain references the checks hold the port to, in plain PyTorch,
importing nothing of the program: the Gibbs resample (`gibbs`), its noise
(`philox`), the MH resample (`alias`) and the count rebuild (`counts`); the
hybrid language model's forward (`hybrid`)."""
