"""Lazily autovivifying configuration tree.

The port's copy of ``veles_tpu/config.py``, a re-design of the reference
config system (veles/config.py:60-152): a ``root`` singleton of attribute
nodes that spring into existence on first access, ``update()`` from nested
dicts, protected keys, per-workflow namespaces, and callable values resolved
at read time via ``get()``.  Values may also be :class:`Range` placeholders
consumed by the genetic optimizer (reference: veles/genetics/config.py);
``fix_config`` collapses them to their plain default for non-optimize runs
(reference: veles/__main__.py:721-723).
"""

import os


class Range:
    """A tuneable config value: a default plus an allowed range/choices.

    The genetic optimizer treats every ``Range`` found in the config tree as
    one gene; everyone else sees ``value``.
    """

    def __init__(self, value, *bounds):
        self.value = value
        if len(bounds) == 2 and not isinstance(bounds[0], (list, tuple)):
            self.min_value, self.max_value = bounds
            self.choices = None
        elif len(bounds) == 1 and isinstance(bounds[0], (list, tuple)):
            self.choices = list(bounds[0])
            self.min_value = self.max_value = None
        elif not bounds:
            self.min_value = self.max_value = value
            self.choices = None
        else:
            raise ValueError("Range(value, min, max) or Range(value, [choices])")

    def __repr__(self):
        if self.choices is not None:
            return "Range(%r, %r)" % (self.value, self.choices)
        return "Range(%r, %r, %r)" % (self.value, self.min_value, self.max_value)

    def __eq__(self, other):
        if isinstance(other, Range):
            return self.value == other.value
        return self.value == other


class Config:
    """One node of the config tree.  Attribute access autovivifies children."""

    _protected = frozenset(("update", "get", "keys", "items", "print_", "path"))

    def __init__(self, path):
        self.__dict__["_path"] = path

    # -- tree construction ---------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self.__dict__["_path"], name))
        self.__dict__[name] = child
        return child

    def __setattr__(self, name, value):
        if name in Config._protected:
            raise AttributeError("'%s' is a protected Config key" % name)
        # NOTE: plain-dict assignment stays a plain dict on purpose
        # (data dicts may have non-string keys, and users compare the
        # value back with ==); tree consumers must accept either form
        # — see znicz/samples/__init__.py build_standard
        self.__dict__[name] = value

    def __delattr__(self, name):
        self.__dict__.pop(name, None)

    # -- mapping-ish API -----------------------------------------------------
    def update(self, tree=None, **kwargs):
        """Recursively merge a nested dict (or kwargs) into this node."""
        if tree is None:
            tree = {}
        if not isinstance(tree, dict):
            raise TypeError("Config.update() takes a dict, got %r" % (tree,))
        tree = dict(tree)
        tree.update(kwargs)
        for key, value in tree.items():
            if key in Config._protected or key.startswith("_"):
                raise AttributeError(
                    "%r is a protected Config key" % key)
            if isinstance(value, dict):
                node = self.__dict__.get(key)
                if not isinstance(node, Config):
                    node = Config("%s.%s" % (self.__dict__["_path"], key))
                    self.__dict__[key] = node
                node.update(value)
            else:
                self.__dict__[key] = value
        return self

    def get(self, name, default=None):
        """Read a leaf; callables are invoked, Ranges collapse to .value."""
        value = self.__dict__.get(name, default)
        if isinstance(value, Config):
            return value
        if isinstance(value, Range):
            return value.value
        if callable(value):
            return value()
        return value

    def keys(self):
        return [k for k in self.__dict__ if not k.startswith("_")]

    def items(self):
        return [(k, self.__dict__[k]) for k in self.keys()]

    def __getitem__(self, name):
        try:
            return self.__dict__[name]
        except KeyError:
            raise KeyError("%s.%s" % (self.__dict__["_path"], name))

    def __contains__(self, name):
        return name in self.__dict__

    def __iter__(self):
        return iter(self.keys())

    @property
    def path(self):
        return self.__dict__["_path"]

    def todict(self):
        out = {}
        for k, v in self.items():
            out[k] = v.todict() if isinstance(v, Config) else v
        return out

    def print_(self, indent=0, file=None):
        import sys
        file = file or sys.stdout
        for k, v in sorted(self.items()):
            if isinstance(v, Config):
                print("%s%s:" % ("  " * indent, k), file=file)
                v.print_(indent + 1, file=file)
            else:
                print("%s%s: %r" % ("  " * indent, k, v), file=file)

    def __repr__(self):
        return "<Config %s: %s>" % (self.__dict__["_path"],
                                    ", ".join(self.keys()) or "(empty)")


def _fix_container(obj):
    """Collapse Ranges inside plain dict/list containers (layer configs
    are dicts in a list — the reference's process_config walked them too,
    genetics/config.py)."""
    if isinstance(obj, Range):
        return obj.value
    if isinstance(obj, dict):
        return {k: _fix_container(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_fix_container(v) for v in obj]
    return obj


def fix_config(cfg):
    """Collapse every Range in the tree to its plain default value."""
    for key, value in list(cfg.__dict__.items()):
        if key.startswith("_"):
            continue
        if isinstance(value, Config):
            fix_config(value)
        elif isinstance(value, (Range, dict, list)):
            cfg.__dict__[key] = _fix_container(value)


def _ranges_in_container(obj, prefix, out):
    if isinstance(obj, Range):
        out.append((prefix, obj))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _ranges_in_container(v, "%s.%s" % (prefix, k), out)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            _ranges_in_container(v, "%s.%d" % (prefix, i), out)


def get_config_ranges(cfg, prefix=None, out=None):
    """Collect (path, Range) pairs for the genetic optimizer, including
    Ranges nested in dict/list values (layer config lists)."""
    if out is None:
        out = []
    prefix = prefix if prefix is not None else cfg.path
    for key, value in cfg.__dict__.items():
        if key.startswith("_"):
            continue
        if isinstance(value, Config):
            get_config_ranges(value, "%s.%s" % (prefix, key), out)
        else:
            _ranges_in_container(value, "%s.%s" % (prefix, key), out)
    return out


def set_config_by_path(cfg, dotted, value):
    """Assign ``root.a.b.c = value`` given the dotted path string.
    Numeric segments index into lists; dict keys are traversed too, so
    GA paths like ``root.mnist.layers.0.<-.learning_rate`` resolve."""
    parts = dotted.split(".")
    if parts and parts[0] == "root":
        parts = parts[1:]
    node = cfg
    for p in parts[:-1]:
        if isinstance(node, list):
            node = node[int(p)]
        elif isinstance(node, dict):
            node = node[p]
        else:
            node = getattr(node, p)
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = value
    elif isinstance(node, dict):
        node[last] = value
    elif isinstance(value, dict):
        # dict override merges as a Config subtree (so CLI overrides like
        # root.x.snapshotter={...} behave like config-file declarations)
        child = getattr(node, last)
        if isinstance(child, Config):
            child.update(value)
        else:
            setattr(node, last, value)
    else:
        setattr(node, last, value)


#: The global configuration tree (reference: veles/config.py:152).
root = Config("root")

_cache_dir = os.path.join(
    os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
    "veles_tpu")

root.update({
    "common": {
        "dirs": {
            "cache": _cache_dir,
            "datasets": os.path.join(_cache_dir, "datasets"),
            "snapshots": os.path.join(_cache_dir, "snapshots"),
            "events": os.path.join(_cache_dir, "events"),
        },
        "engine": {
            # "cuda" | "cpu" | "auto" (auto means cuda: the port never
            # falls back to the host on its own, backends.py)
            "backend": "auto",
            # the compensated GEMM is opt-in per unit (All2All(
            # precise_gemm=N)) or for every unit through
            # ``engine.precise_gemm``, read with a default of 0
        },
        "compile_cache": {
            # persistent build cache of the CUDA kernels + warmup
            # manifests (veles_tpu_torch/compilecache/): kernel
            # libraries are built into and loaded from ``dir``, so a
            # restart runs no nvcc.  None = off (kernels build into
            # build/veles_tpu_torch/ of the checkout);
            # $VELES_COMPILE_CACHE_DIR overrides for child processes.
            "dir": None,
            "enabled": True,
            # size-budget LRU sweep over the store directory
            "max_bytes": 4 << 30,
            # serving warmup: warm the first manifest bucket
            # synchronously, the rest of the ladder on a background
            # thread (the server answers before the tail finishes)
            "background_warmup": False,
        },
        "autotune": {
            # persistent kernel/serving plan tuning (veles_tpu_torch/
            # autotune/): measured winners keyed by (site, shape class,
            # torch/CUDA versions, the card, the toolchain, the kernel
            # sources) live under ``dir`` and the call sites resolve
            # through them.  None = every site uses its default, byte
            # for byte the behavior without a tuner;
            # $VELES_AUTOTUNE_DIR overrides for child processes.
            "dir": None,
            "enabled": True,
        },
        "snapshot": {
            # checkpoint/save_state: target chunk size for tensor bands
            "chunk_bytes": 16 << 20,
        },
        "trace": {"enabled": False, "file": None},
        "timings": set(),
        "random_seed": 1234,
    },
})
