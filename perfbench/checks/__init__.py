"""The comparison with the plain reference that decides `correct`: one
module a traffic kind, each returning {number: value} for the limits'
file to judge."""

import importlib


def checker(kind: str):
    return importlib.import_module(f"perfbench.checks.{kind}")


def judge(numbers: dict, limits: dict):
    """{name: {"value", "limit"}} for every limit, and whether each value
    lies at or under its limit (a value that is not a number fails)."""
    out, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": spec["limit"]}
        ok = ok and value == value and value <= spec["limit"]
    return out, ok
