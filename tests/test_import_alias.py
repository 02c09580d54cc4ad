"""The package's former import path (a package directory beside
``online_convex_optimization``) resolves to the very same modules."""

import importlib
import pathlib

import pytest

import online_convex_optimization

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALIASES = sorted(p.parent.name for p in
                 ROOT.glob("online_convex_optimization_*/__init__.py"))


def test_former_import_path_ships():
    assert len(ALIASES) == 1, ALIASES


@pytest.mark.parametrize("sub", ["models.linear", "ops.pallas_game",
                                 "experiments.config", "parallel.sweep",
                                 "data.device"])
def test_former_import_path_is_the_same_module(sub):
    for alias in ALIASES:
        old = importlib.import_module(f"{alias}.{sub}")
        assert old is importlib.import_module(
            f"online_convex_optimization.{sub}")


def test_former_import_path_top_level_names():
    for alias in ALIASES:
        pkg = importlib.import_module(alias)
        for name in online_convex_optimization.__all__:
            assert getattr(pkg, name) is getattr(online_convex_optimization,
                                                 name)
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"{alias}.no_such_module")
