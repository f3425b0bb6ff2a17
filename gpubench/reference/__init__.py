"""The benchmark's plain reference: ImprovedUNet, the tiled pyramid blend,
the structure loss and Adam, in plain PyTorch and numpy. It imports nothing
of the program, and it regenerates the weights and inputs from the seed
rather than take what the program made."""
