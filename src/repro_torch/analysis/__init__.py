"""repro_torch.analysis — correctness tooling for the replay stack.

Three parts (see ``docs/analysis.md``):

* :mod:`repro_torch.analysis.lint` — the stdlib-``ast`` determinism linter
  (``python -m repro_torch.analysis.lint src/repro_torch``);
* :mod:`repro_torch.analysis.simsan` — SimSan, the opt-in runtime invariant
  sanitizer (``REPRO_SIMSAN=1`` / ``Network(sanitize=True)``);
* :mod:`repro_torch.analysis.races` — the sim-time race detector
  (``python -m repro_torch.analysis.races --smoke``).

Only the sanitizer surface is re-exported here:
``repro_torch.net.network`` imports it at module load, so this
``__init__`` must stay free of any import that reaches back into
``repro_torch.net`` / ``repro_torch.sim`` (``lint`` and ``races`` are
imported as submodules on demand).
"""
from repro_torch.analysis.simsan import Sanitizer, SanitizerError, enabled

__all__ = ["Sanitizer", "SanitizerError", "enabled"]
