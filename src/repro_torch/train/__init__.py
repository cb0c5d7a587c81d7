from repro_torch.train.train_step import TrainState, build_train_step  # noqa: F401
from repro_torch.train.trainer import Trainer  # noqa: F401
