from . import checkpoint, optimizer, train_loop  # noqa: F401
from .optimizer import AdamWConfig  # noqa: F401
from .train_loop import init_train_state, make_train_step  # noqa: F401
