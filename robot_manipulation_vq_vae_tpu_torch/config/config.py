"""Locking attribute-dict config.

Re-implementation (from scratch, same observable semantics) of the reference
config object (``robomimic/config/config.py``): a nested dict whose keys are
exposed as attributes, with a two-level locking scheme:

  * key-locked   -- no new keys may be added (value edits still allowed)
  * fully locked -- neither keys nor values may change

plus ``do_not_lock_keys()`` escape for kwargs-style sub-configs, and the
``unlocked()`` / ``values_unlocked()`` context managers used by the training
entry point when overriding a template config from a JSON file.
"""

import contextlib
import copy
import json

# Attribute names that live on the object itself (not in the dict).
_SLOTS = ("_cfg_key_locked", "_cfg_all_locked", "_cfg_keys_not_lockable")


class Config(dict):
    """Nested attribute-dict with key/value locking."""

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "_cfg_key_locked", False)
        object.__setattr__(self, "_cfg_all_locked", False)
        object.__setattr__(self, "_cfg_keys_not_lockable", False)
        kwargs.pop("__parent", None)
        kwargs.pop("__key", None)
        for arg in args:
            if not arg:
                continue
            if isinstance(arg, dict):
                for k, v in arg.items():
                    self[k] = _wrap(v)
            else:
                for k, v in iter(arg):
                    self[k] = _wrap(v)
        for k, v in kwargs.items():
            self[k] = _wrap(v)

    # ---------------------------------------------------------------- locking
    @property
    def is_locked(self):
        return object.__getattribute__(self, "_cfg_all_locked")

    @property
    def is_key_locked(self):
        return object.__getattribute__(self, "_cfg_key_locked")

    @property
    def key_lockable(self):
        return not object.__getattribute__(self, "_cfg_keys_not_lockable")

    def do_not_lock_keys(self):
        """Mark this (sub-)config as exempt from key-locking (kwargs blocks)."""
        object.__setattr__(self, "_cfg_keys_not_lockable", True)

    def _walk_children(self):
        for v in self.values():
            if isinstance(v, Config):
                yield v

    def lock(self):
        """Fully lock: no key additions, no value changes (recursive)."""
        object.__setattr__(self, "_cfg_all_locked", True)
        if self.key_lockable:
            object.__setattr__(self, "_cfg_key_locked", True)
        for child in self._walk_children():
            child.lock()

    def unlock(self):
        object.__setattr__(self, "_cfg_all_locked", False)
        object.__setattr__(self, "_cfg_key_locked", False)
        for child in self._walk_children():
            child.unlock()

    def lock_keys(self):
        if not self.key_lockable:
            return
        object.__setattr__(self, "_cfg_key_locked", True)
        for child in self._walk_children():
            child.lock_keys()

    def unlock_keys(self):
        object.__setattr__(self, "_cfg_key_locked", False)
        for child in self._walk_children():
            child.unlock_keys()

    def _lock_state(self):
        state = {".all": self.is_locked, ".key": self.is_key_locked}
        for k, v in self.items():
            if isinstance(v, Config):
                state[k] = v._lock_state()
        return state

    def _restore_lock_state(self, state):
        object.__setattr__(self, "_cfg_all_locked", state[".all"])
        object.__setattr__(self, "_cfg_key_locked", state[".key"])
        for k, sub in state.items():
            if k in (".all", ".key"):
                continue
            if k in self and isinstance(self[k], Config):
                self[k]._restore_lock_state(sub)

    @contextlib.contextmanager
    def unlocked(self):
        """Temporarily allow both key and value updates.

        On exit the *top-level* lock state is re-applied recursively (via
        ``lock()`` / ``lock_keys()``), so sub-configs added inside the scope
        end up locked too - reference semantics (``config.py:114-124``, which
        saves only the root state and re-locks recursively)."""
        was_locked, was_key_locked = self.is_locked, self.is_key_locked
        self.unlock()
        try:
            yield self
        finally:
            if was_locked:
                self.lock()
            if was_key_locked:
                self.lock_keys()

    @contextlib.contextmanager
    def values_unlocked(self):
        """Temporarily allow value updates only (no new keys)."""
        was_locked, was_key_locked = self.is_locked, self.is_key_locked
        self.unlock()
        self.lock_keys()
        try:
            yield self
        finally:
            if was_locked:
                self.lock()
            if was_key_locked:
                self.lock_keys()
            elif not was_locked:
                # the reference leaves keys locked here (its _set_lock_state
                # only ever locks, config.py:99-112); we restore instead so a
                # fully-unlocked config round-trips - divergence is unreachable
                # from the training path, where configs are always locked
                self.unlock_keys()

    # ------------------------------------------------------------- dict hooks
    def __setitem__(self, key, value):
        if self.is_locked:
            raise RuntimeError(
                "Config is locked - cannot set '{}'".format(key)
            )
        if self.is_key_locked and key not in self:
            raise RuntimeError(
                "Config is key-locked - cannot add new key '{}'".format(key)
            )
        # NOTE: values assigned after __init__ are stored as-is (plain dicts stay
        # plain and therefore lock-exempt) - this matches reference semantics,
        # which only wraps dicts during Config.__init__ (reference config.py:202,218).
        super().__setitem__(key, value)

    def __getitem__(self, key):
        if key not in self:
            if self.is_locked or self.is_key_locked:
                raise RuntimeError(
                    "Config is locked and key '{}' does not exist".format(key)
                )
            # auto-vivify empty sub-config (addict behavior)
            child = Config()
            super().__setitem__(key, child)
            return child
        return super().__getitem__(key)

    def __setattr__(self, name, value):
        if name in _SLOTS:
            object.__setattr__(self, name, value)
            return
        if hasattr(Config, name) and not name.startswith("_cfg"):
            raise AttributeError("'{}' is read-only on Config".format(name))
        self[name] = value

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self[name]

    def __delattr__(self, name):
        del self[name]

    # ----------------------------------------------------------------- update
    def update(self, *args, **kwargs):
        """Deep-merge another mapping into this config, honoring locks.

        Mirrors reference semantics (reference ``config.py:270-288``): raises
        if fully locked; raises on unknown keys when key-locked; nested dicts
        merge recursively, everything else overwrites.
        """
        if self.is_locked:
            raise RuntimeError("Cannot update - config is locked")
        other = {}
        if args:
            if len(args) > 1:
                raise TypeError("update expects at most 1 positional arg")
            other.update(args[0])
        other.update(kwargs)
        for k, v in other.items():
            if self.is_key_locked and k not in self:
                raise RuntimeError(
                    "Cannot update - config is key-locked and key '{}' "
                    "does not exist".format(k)
                )
            cur = self.get(k, None)
            if isinstance(cur, Config) and isinstance(v, dict):
                cur.update(v)
            elif isinstance(cur, dict) and isinstance(v, dict):
                cur.update(v)  # plain dict: shallow merge, lock-exempt
            else:
                self[k] = v

    def setdefault(self, key, default=None):
        if key in self:
            return self[key]
        self[key] = default
        return self[key]

    # ------------------------------------------------------------------ io
    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = type(v)(
                    e.to_dict() if isinstance(e, Config) else e for e in v
                )
            else:
                out[k] = v
        return out

    def dump(self, filename=None):
        s = json.dumps(self.to_dict(), indent=4)
        if filename is not None:
            with open(filename, "w") as f:
                f.write(s)
        return s

    def __repr__(self):
        return json.dumps(self.to_dict(), indent=4)

    # --------------------------------------------------------------- copying
    def copy(self):
        return copy.copy(self)

    def deepcopy(self):
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        other = self.__class__()
        memo[id(self)] = other
        for k, v in self.items():
            dict.__setitem__(other, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return other

    def __reduce__(self):
        return (self.__class__, (self.to_dict(),))


def _wrap(value):
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value
