"""The benchmark's plain reference: exact neighbours in float32 with TF32
off and float64 re-ranking, recall, and the checks of an index and of an
answer list.  Plain PyTorch and NumPy; imports nothing of the program."""
