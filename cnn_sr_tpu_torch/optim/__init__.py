from .sgd import init_optimizer_state, update_parameters

__all__ = ["init_optimizer_state", "update_parameters"]
