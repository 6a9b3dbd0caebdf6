"""repro-lint for the PyTorch/CUDA port — an invariant-checking static
analyzer for the step, hook, engine and kernel stack.  Counterpart of
``repro.analysis``; it imports neither ``jax`` nor ``repro``.

  * :mod:`repro_torch.analysis.core` — the shared traversal engine:
    import-alias resolution, scope-aware function collection, hot-context
    inference (the bodies a step builder returns, and what they reach), a
    conservative taint walk for tensors, and inline ``# repro-lint:
    disable=T2`` suppression parsing;
  * :mod:`repro_torch.analysis.rules` — the rule set: T2–T5, the
    reference's R2–R5 in torch form, and R6/R7 carried over (the table in
    its docstring; R1 has no counterpart);
  * :mod:`repro_torch.analysis.baseline` — the committed-baseline format
    (every entry carries a one-line justification; stale entries are
    errors), the reference's, in the port's own file
    ``.repro-torch-lint-baseline.json``;
  * :mod:`repro_torch.analysis.lint` — the CLI:
    ``python -m repro_torch.analysis.lint [paths] --format text|json``.
"""
from repro_torch.analysis.core import Finding, ModuleModel, analyze_module
from repro_torch.analysis.rules import ALL_RULES

__all__ = ["Finding", "ModuleModel", "analyze_module", "lint_paths",
           "main", "ALL_RULES"]


def __getattr__(name):
    # lint is imported lazily so ``python -m repro_torch.analysis.lint``
    # doesn't trip runpy's found-in-sys.modules warning.
    if name in ("lint_paths", "main"):
        from repro_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(name)
