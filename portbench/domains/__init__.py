"""The problem a cell runs, behind the harness's generic loop.

A configuration names its ``domain`` (``pic`` where it names none), and
``portbench/domains/<domain>.py`` provides:

  * ``draw(config, seed, device)``: the plain inputs, drawn from the seed
    on the device;
  * ``describe(plain)``: a few words on them for the set-up log line;
  * ``reference(plain, traffic, path)``: what the plain reference computes
    for the stretch the traffic mix runs (``path``: the entry's module,
    whose semantics the reference may follow);
  * ``numbers(outcome, ref, plain)``: every number the output check
    compares, by name; ``portbench/limits/<workload>.json`` limits them;
  * ``context(entry, rows, plain)``: the fields the per-layer readers may
    read beside ``trace``, ``host`` and ``remake_s``, from the traced
    intervals' ``rows``; among them ``step_bounds_s``, the least time the
    card could take for each traced step's work, which ``step_mfu`` reads;
  * ``control(plain, traffic, path)`` where the domain has one: the
    reference one precision lower, in the form of the entry's outcome.

A new domain is this module plus its inputs, its entry
(``portbench/entries/<entry>.py``) and its plain reference.
"""
from __future__ import annotations

import importlib

__all__ = ["name", "module", "DEFAULT"]

#: the domain of a configuration that names none
DEFAULT = "pic"


def name(config: dict) -> str:
    return config.get("domain", DEFAULT)


def module(config: dict):
    """``portbench/domains/<domain>.py`` of ``config``."""
    return importlib.import_module(f"portbench.domains.{name(config)}")
