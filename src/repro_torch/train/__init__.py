"""Training (counterpart of ``repro.train``): the step and the loop."""
from repro_torch.train.loop import train
from repro_torch.train.step import init_train_state, make_train_step

__all__ = ["init_train_state", "make_train_step", "train"]
