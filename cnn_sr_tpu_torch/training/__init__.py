from .samples import SampleSet, divide_samples, find_training_samples, load_sample_set
from .trainer import TrainState, train_loop, make_train_step, make_validation_fn

__all__ = [
    "SampleSet",
    "find_training_samples",
    "load_sample_set",
    "divide_samples",
    "TrainState",
    "train_loop",
    "make_train_step",
    "make_validation_fn",
]
