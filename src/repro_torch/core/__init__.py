"""Optimizers: first-order backends, schedules, stat plumbing, MKOR and
its second-order baselines (KFAC, Eva, SNGD), exported as the reference's
``repro/core/__init__.py`` exports them, except the function ``mkor``:
its name is the submodule's (``from repro_torch.core import mkor`` gives
the module, as the port's code uses it).  ``kfac``, ``eva`` and ``sngd``
here are the functions; their modules load by their dotted paths."""
from repro_torch.core.firstorder import (  # noqa: F401
    GradientTransformation,
    adam,
    adamw,
    apply_updates,
    chain,
    clip_by_global_norm,
    lamb,
    sgd,
)
from repro_torch.core.mkor import MKORConfig, mkor_h  # noqa: F401
from repro_torch.core.kfac import KFACConfig, kfac  # noqa: F401
from repro_torch.core.eva import EvaConfig, eva  # noqa: F401
from repro_torch.core.sngd import SNGDConfig, sngd  # noqa: F401
