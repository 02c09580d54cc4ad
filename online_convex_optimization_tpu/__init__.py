"""The package's former import path, kept so existing scripts still import.

Every module name under this package resolves to the module object of the
same name in :mod:`online_convex_optimization` (``sys.modules`` holds the
one module under both names), so classes, jit caches and module state are
shared.  New code imports :mod:`online_convex_optimization` directly.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import online_convex_optimization as _target
from online_convex_optimization import *  # noqa: F401,F403

_PREFIX = __name__ + "."


def _real_name(alias: str) -> str:
    return _target.__name__ + "." + alias[len(_PREFIX):]


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path=None, target=None):
        if (not fullname.startswith(_PREFIX)
                or importlib.util.find_spec(_real_name(fullname)) is None):
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        # The import system returns whatever sys.modules holds under the
        # name once this returns: the real module.
        sys.modules[module.__name__] = importlib.import_module(
            _real_name(module.__name__))


# First in line: the path finder would otherwise load a second copy of a
# submodule from the real package's directory under the old name.
if not any(isinstance(f, _AliasFinder) for f in sys.meta_path):
    sys.meta_path.insert(0, _AliasFinder())
__path__ = []  # a package, so submodule imports reach the finder
__all__ = getattr(_target, "__all__", [])
