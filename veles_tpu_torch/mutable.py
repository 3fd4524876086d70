"""Mutable boolean gate expressions and cross-unit attribute links.

Re-design of the reference's gate algebra (veles/mutable.py:
``Bool`` at :44, ``LinkableAttribute`` at :219).  A :class:`Bool` is a mutable
truth cell; combining Bools with ``&``, ``|``, ``^`` and ``~`` produces *lazy*
expression Bools that re-evaluate their operands every time they are tested,
so a unit gate such as ``decision.complete | loader.epoch_ended`` tracks its
inputs live.  Assignment is ``b <<= value``.
"""


class Bool:
    """Mutable boolean with lazy operator expressions.

    >>> a, b = Bool(False), Bool(True)
    >>> expr = a | b
    >>> bool(expr)
    True
    >>> b <<= False
    >>> bool(expr)
    False
    """

    __slots__ = ("_value", "_expr", "on_true", "on_false", "name")

    def __init__(self, value=False, name=None):
        self._expr = None
        self._value = bool(value)
        self.on_true = None
        self.on_false = None
        self.name = name

    # -- evaluation ----------------------------------------------------------
    def __bool__(self):
        if self._expr is not None:
            return self._expr()
        return self._value

    def __ilshift__(self, value):
        """``b <<= x`` assigns; fires on_true/on_false callbacks on edges."""
        if self._expr is not None:
            raise ValueError("cannot assign to a derived Bool expression")
        old = self._value
        self._value = bool(value)
        if self._value and not old and self.on_true is not None:
            self.on_true()
        if not self._value and old and self.on_false is not None:
            self.on_false()
        return self

    # -- operators (lazy) ----------------------------------------------------
    @staticmethod
    def _coerce(other):
        if isinstance(other, Bool):
            return other
        return Bool(bool(other))

    def _derived(self, fn, name):
        b = Bool(name=name)
        b._expr = fn
        return b

    def __or__(self, other):
        other = Bool._coerce(other)
        return self._derived(lambda: bool(self) or bool(other),
                             "(%s | %s)" % (self, other))

    __ror__ = __or__

    def __and__(self, other):
        other = Bool._coerce(other)
        return self._derived(lambda: bool(self) and bool(other),
                             "(%s & %s)" % (self, other))

    __rand__ = __and__

    def __xor__(self, other):
        other = Bool._coerce(other)
        return self._derived(lambda: bool(self) != bool(other),
                             "(%s ^ %s)" % (self, other))

    __rxor__ = __xor__

    def __invert__(self):
        return self._derived(lambda: not bool(self), "~%s" % self)

    @classmethod
    def from_callable(cls, fn, name=None):
        """A derived Bool evaluating ``fn()`` each test — for gates over
        non-Bool state (e.g. ``loader.minibatch_class != TRAIN``)."""
        b = cls(name=name)
        b._expr = lambda: bool(fn())
        return b

    # -- misc ----------------------------------------------------------------
    @property
    def is_derived(self):
        return self._expr is not None

    def __repr__(self):
        if self.name:
            return self.name
        if self._expr is not None:
            return "<Bool expr=%s>" % bool(self)
        return "<Bool %s>" % self._value

    def __getstate__(self):
        # Derived expressions cannot be pickled (they close over operands in
        # the live graph); they are reconstructed by re-linking on restore.
        return {"value": bool(self), "name": self.name}

    def __setstate__(self, state):
        self._expr = None
        self._value = state["value"]
        self.name = state.get("name")
        self.on_true = self.on_false = None


def link_attribute(dst, name, src, src_name, two_way=False):
    """Make ``dst.name`` a live pointer to ``src.src_name``.

    Serves the role of the reference LinkableAttribute (veles/mutable.py:219)
    but the routing lives in ``dst.__dict__['_linked_attrs']`` and is honored
    by ``Unit.__getattribute__``/``__setattr__`` — no class mutation, so
    instances of one class may link differently.  ``two_way=True`` propagates
    writes back to the source; one-way writes break the link (reference
    semantics: the attribute becomes locally owned again).
    """
    dst.__dict__.setdefault("_linked_attrs", {})[name] = (src, src_name,
                                                          bool(two_way))


def unlink_attribute(dst, name):
    dst.__dict__.get("_linked_attrs", {}).pop(name, None)
