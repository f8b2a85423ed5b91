"""Run-time contract checks of the port (counterpart of ``repro/analysis``).

The reference proves MKOR's structural claims statically, on jaxprs and
compiled HLO.  PyTorch has neither, so the port checks what a run shows:
the wire log of ``sharding/collectives.py`` and the optimizer's state tree.

``diagnostics``  Diagnostic / Report containers and rendering
``contracts``    the checkers the wire log can show, with the reference's
                 names and codes
``lint``         CLI: ``python -m repro_torch.analysis.lint --config NAME``
"""
from repro_torch.analysis.diagnostics import (  # noqa: F401
    Diagnostic, Report, Severity)
