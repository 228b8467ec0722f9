"""Shared loader for local HF checkpoint directories.

The reference accepts ANY encoder name via ``from_pretrained``
(model.py:69-81); in the no-network build the equivalent surface is a
local checkpoint DIRECTORY (the layout ``from_pretrained`` consumes).
One helper serves both encoder families so the model_type guard and the
config read can't drift between them.
"""

from __future__ import annotations

import json
import os


def local_hf_arch(model_name: str, expected_type: str,
                  config_cls_name: str, arch_cls, option_name: str):
    """Build ``arch_cls.from_hf_config`` from a local HF checkpoint dir.

    Returns None when ``model_name`` is not a directory with a
    ``config.json`` (caller falls through to its preset table).
    ``from_pretrained`` only WARNS on a model_type mismatch and returns a
    default-valued config — a wrong-family directory would silently build
    a wrong-dimension arch and die later with an opaque shape error — so
    the declared type is checked up front and raises loudly.
    """
    if not (os.path.isdir(model_name)
            and os.path.exists(os.path.join(model_name, "config.json"))):
        return None
    with open(os.path.join(model_name, "config.json")) as f:
        declared = json.load(f).get("model_type")
    if declared not in (None, expected_type):
        raise ValueError(
            f"{model_name!r} declares model_type={declared!r} in its "
            f"config.json; {option_name} needs a {expected_type!r} "
            f"checkpoint directory.")
    import transformers
    config_cls = getattr(transformers, config_cls_name)
    return arch_cls.from_hf_config(config_cls.from_pretrained(model_name))
