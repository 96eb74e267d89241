"""Training: the contrastive step and the trainer around it."""
from warpedganspace_torch.train.train_step import (StepChunk, TrainState,  # noqa: F401
                                                   TrainStepConfig, init_train_state, loss_fn,
                                                   make_optimizers, train_step)
from warpedganspace_torch.train.trainer import Trainer  # noqa: F401
