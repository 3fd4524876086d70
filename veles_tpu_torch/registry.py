"""Class registries.

Re-design of the reference registries:
- ``UnitRegistry`` metaclass auto-registers every Unit subclass for
  introspection and the frontend (reference: veles/unit_registry.py:51).
- ``MappedObjectsRegistry`` maps string keys to classes for pluggable families
  (normalizers, snapshotters, loaders; reference:
  veles/mapped_object_registry.py).
"""

import uuid


class UnitRegistry(type):
    """Metaclass: every concrete Unit subclass lands in ``UnitRegistry.units``.

    Classes may set ``hide_from_registry = True`` (abstract bases) and may
    carry a stable ``UUID`` used by the export path (the reference's C++
    UnitFactory resolves units by UUID, libVeles/src/unit_factory.cc:37-65).
    """

    units = {}

    def __new__(mcs, name, bases, clsdict):
        cls = super().__new__(mcs, name, bases, clsdict)
        if not clsdict.get("hide_from_registry", False):
            UnitRegistry.units[name] = cls
            if "UUID" not in clsdict:
                # deterministic UUID from qualified name
                cls.UUID = str(uuid.uuid5(uuid.NAMESPACE_DNS,
                                          "veles_tpu." + name))
        return cls

    @staticmethod
    def find(name):
        return UnitRegistry.units.get(name)

    @staticmethod
    def find_by_uuid(uid):
        for cls in UnitRegistry.units.values():
            if getattr(cls, "UUID", None) == uid:
                return cls
        return None


class MappedObjectsRegistry(type):
    """Metaclass for string-keyed class families.

    A family base sets ``mapping = "familyname"`` and a fresh ``registry``
    dict; members set ``MAPPING = "key"``.
    """

    registries = {}

    def __new__(mcs, name, bases, clsdict):
        cls = super().__new__(mcs, name, bases, clsdict)
        family = getattr(cls, "mapping", None)
        if family is not None:
            reg = MappedObjectsRegistry.registries.setdefault(family, {})
            key = clsdict.get("MAPPING")
            if key is not None:
                reg[key] = cls
        return cls

    @staticmethod
    def get(family, key):
        try:
            return MappedObjectsRegistry.registries[family][key]
        except KeyError:
            raise KeyError(
                "no %r registered in family %r (have: %s)" % (
                    key, family, sorted(
                        MappedObjectsRegistry.registries.get(family, {}))))
