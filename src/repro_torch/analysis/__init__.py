"""repro_torch.analysis — correctness tooling for the replay stack.

The port carries SimSan, the opt-in runtime invariant sanitizer
(:mod:`repro_torch.analysis.simsan`; ``REPRO_SIMSAN=1`` /
``Network(sanitize=True)``), because ``repro_torch.net.network`` imports
it at module load.  The determinism linter and the race detector of the
reference package are not ported yet (ROADMAP queue A).

This ``__init__`` must stay free of any import that reaches back into
``repro_torch.net``.
"""
from repro_torch.analysis.simsan import Sanitizer, SanitizerError, enabled

__all__ = ["Sanitizer", "SanitizerError", "enabled"]
