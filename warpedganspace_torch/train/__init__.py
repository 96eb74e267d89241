"""Training: the contrastive step and the trainer around it."""
from warpedganspace_torch.train.train_step import (TrainState, TrainStepConfig,  # noqa: F401
                                                   init_train_state, loss_fn,
                                                   make_optimizers, train_step)
from warpedganspace_torch.train.trainer import Trainer  # noqa: F401
