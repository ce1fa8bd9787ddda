from .state import TrainState, create_train_state, make_optimizer  # noqa: F401
from .steps import build_step, make_mpscl_step  # noqa: F401
