"""The reference's model, found by its family: each configuration's
``arch.family`` names a module ``portbench/reference/families/<family>.py``
(the interface is in ``families/__init__.py``), so a new family is a new
file, and no shared code tests a family's name.

:func:`param_specs` is the family's own, kept here under the name
``portbench/weights.py`` and the tests use.
"""

from __future__ import annotations

import importlib


def family(arch: dict):
    """The family module of a configuration's ``arch``."""
    return importlib.import_module(f"portbench.reference.families.{arch['family']}")


def param_specs(arch: dict) -> list[tuple[str, tuple, str, int]]:
    """Every parameter of the model: (name, shape, init kind, fan-in)."""
    return family(arch).param_specs(arch)

