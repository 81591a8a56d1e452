"""Load PipelineSpecs from JSON files (the ``--pipeline pipe.json``
path of the launch CLI, and what ``tools/validate_spec.py`` lints for
pipeline-shaped files).  A loaded pipeline is validated immediately —
cycles, unknown stage refs and unknown triggers fail here with
structured errors, never mid-run.
"""
from __future__ import annotations

import json

from repro_torch.flow.spec import PipelineSpec
from repro_torch.spec.workload import SpecError


def load_pipeline(path: str) -> PipelineSpec:
    """Read + strict-parse + validate one pipeline file."""
    with open(path) as f:
        raw = json.load(f)
    pspec = PipelineSpec.from_dict(raw)     # raises SpecError on drift
    return pspec.validate()


def check_pipeline(path: str):
    """Lint one pipeline file: returns (spec_or_None, errors)."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return None, [{"field": path, "code": "unreadable",
                       "message": str(e)}]
    try:
        pspec = PipelineSpec.from_dict(raw)
    except SpecError as e:
        return None, e.errors
    errors = list(pspec.errors())
    # round-trip: what we parsed must serialize back to an equal spec
    if PipelineSpec.from_dict(pspec.to_dict()) != pspec:
        errors.append({"field": path, "code": "round-trip",
                       "message": "to_dict/from_dict round-trip drifted"})
    return pspec, errors


def is_pipeline_doc(raw) -> bool:
    """Heuristic shared with ``tools/validate_spec.py``: a JSON object
    is pipeline-shaped when it declares stages (or says so)."""
    return isinstance(raw, dict) and (
        raw.get("kind") == "pipeline" or "stages" in raw)
