from .config import Config, LayerSpec, ParametersDistribution, read_config
from .params_io import (
    load_parameters_file,
    params_to_torch,
    random_parameters,
    save_parameters_file,
)

__all__ = [
    "Config",
    "LayerSpec",
    "ParametersDistribution",
    "read_config",
    "load_parameters_file",
    "params_to_torch",
    "random_parameters",
    "save_parameters_file",
]
