"""Priority classes of the scheduler, copied from
``modal_examples_tpu/scheduling/policy.py`` (``PRIORITY_CLASSES``,
``DEFAULT_CLASS``, ``CLASS_RANK``, ``validate_class``).

The port's engine serves one FIFO; the policies that order the classes and
share a class among tenants are not ported yet (ROADMAP A6). The OpenAI
server validates a request's class with :func:`validate_class`, so a typo'd
class is a 400 as in the reference.
"""

from __future__ import annotations

#: priority classes, highest first (the order is the strict service order);
#: "canary" is the synthetic golden-set probe class
PRIORITY_CLASSES = ("interactive", "default", "batch", "canary")
DEFAULT_CLASS = "default"
#: class -> rank (lower serves first)
CLASS_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}


def validate_class(name: str) -> str:
    """Return ``name`` if it is a known priority class, else raise, so that
    a typo'd class is a 400, not a silent ``default``."""
    if name not in CLASS_RANK:
        raise ValueError(f"unknown priority class {name!r}; known: {PRIORITY_CLASSES}")
    return name
