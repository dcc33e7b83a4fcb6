"""An in-memory stand-in for an open ``h5py.File``, for hosts without h5py.

``MemoryStore`` has the part of h5py's ``File`` / ``Group`` surface that the
data path reads and that a writer of demo files uses: ``store["a/b"]``,
``"a/b" in store``, ``keys()``, ``attrs``, ``create_group``,
``create_dataset(name, data=...)``, item assignment and deletion, ``close()``
and ``with``. A dataset is the numpy array itself, so ``store[path][()]`` and
slices read it as h5py would. To read demos from one, replace
``data.dataset.open_hdf5`` with a function that returns it.
"""

import numpy as np


class MemoryStore:
    """A group of named groups and arrays, addressed by '/'-separated paths."""

    def __init__(self):
        self._children = {}
        self.attrs = {}

    def _parent(self, path, create=False):
        """(the group holding the last part of @path, that part)."""
        parts = path.strip("/").split("/")
        node = self
        for part in parts[:-1]:
            if part not in node._children:
                if not create:
                    raise KeyError(path)
                node._children[part] = MemoryStore()
            node = node._children[part]
            if not isinstance(node, MemoryStore):
                raise KeyError(f"{path}: {part} is a dataset")
        return node, parts[-1]

    def __getitem__(self, path):
        node, name = self._parent(path)
        if name not in node._children:
            raise KeyError(path)
        return node._children[name]

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __setitem__(self, path, value):
        node, name = self._parent(path, create=True)
        node._children[name] = np.asarray(value)

    def __delitem__(self, path):
        node, name = self._parent(path)
        del node._children[name]

    def __iter__(self):
        return iter(self.keys())

    def keys(self):
        return list(self._children)

    def create_group(self, path):
        node, name = self._parent(path, create=True)
        if name in node._children:
            raise ValueError(f"{path} exists")
        node._children[name] = MemoryStore()
        return node._children[name]

    def create_dataset(self, path, data):
        self[path] = data
        return self[path]

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
