"""The runs here are tiny: one host thread each keeps them at seconds on a
host whose cores other work shares, where a pool as wide as the machine
slows them several times over."""
import torch

torch.set_num_threads(1)
