"""The comparison with the plain reference that decides `correct`: one
module a driver (perfbench/loops/__init__.py), named as its loop module,
each returning {number: value} for the limits' file to judge."""

import importlib
import importlib.util


def require(name: str):
    """Fails, before set-up, where the driver `name` has no check module;
    `checker` imports it only once the window has closed."""
    if importlib.util.find_spec(f"perfbench.checks.{name}") is None:
        raise ModuleNotFoundError(f"no check module perfbench.checks.{name}")


def checker(name: str):
    return importlib.import_module(f"perfbench.checks.{name}")


def judge(numbers: dict, limits: dict):
    """{name: {"value", "limit"}} for every limit, and whether each value
    lies at or under its limit (a value that is not a number fails)."""
    out, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": spec["limit"]}
        ok = ok and value == value and value <= spec["limit"]
    return out, ok
