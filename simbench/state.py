"""Copies of the program's state that the check compares after the window."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def snapshot(data) -> Dict:
    """A flat dict of device copies of a ``Data`` dataclass (and of its
    ``Contact``): ``data.<field>``, ``contact.<field>``, ``extras.<key>``.
    Host arrays (the contact's geom ids) are kept as they are."""
    out = {}

    def put(prefix, value):
        if isinstance(value, torch.Tensor):
            out[prefix] = value.detach().clone()
        elif value is not None:
            out[prefix] = value

    for f in dataclasses.fields(data):
        value = getattr(data, f.name)
        if f.name == "contact" and value is not None:
            for g in dataclasses.fields(value):
                put(f"contact.{g.name}", getattr(value, g.name))
        elif f.name == "extras":
            for k, v in (value or {}).items():
                put(f"extras.{k}", v)
        else:
            put(f"data.{f.name}", value)
    return out
