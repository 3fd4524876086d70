"""Interface verification: fail fast on unimplemented unit contracts.

The port's copy of ``veles_tpu/verified.py``, a re-creation of
veles/verified.py (:45): the reference
verified zope.interface contracts (IUnit, ILoader, ...) at construction
so a half-implemented unit failed before training started.  Without
zope, the same guarantee comes from explicit contract lists: a base
class declares ``CONTRACT = ("method", ...)`` and
:func:`verify_contract` asserts each is overridden (not the base's
NotImplementedError stub) — called from the bases' ``initialize``.
``Unit.verify_demands`` (attribute-level) complements this
method-level check.
"""


def verify_contract(obj, base):
    """Raise TypeError when ``obj`` leaves a CONTRACT method of ``base``
    unimplemented."""
    contract = getattr(base, "CONTRACT", ())
    missing = []
    for name in contract:
        impl = getattr(type(obj), name, None)
        if impl is None or impl is getattr(base, name, None):
            missing.append(name)
    if missing:
        raise TypeError(
            "%s does not implement required %s methods: %s (reference "
            "verified.py contract check)" %
            (type(obj).__name__, base.__name__, ", ".join(missing)))
