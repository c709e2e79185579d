"""Copy of ``modal_examples_tpu/web/registry.py``: maps deployed web endpoints to live local URLs.

The reference platform assigns stable ``*.modal.run`` URLs per endpoint
(``f.get_web_url()``, text_to_image.py:254). Locally, ``python -m modal_examples_tpu_torch serve`` binds
a host port per app and records it here so ``get_web_url`` resolves in any
process on the host.
"""

from __future__ import annotations

import json
from pathlib import Path

from .._internal import config as _config


def _path() -> Path:
    return _config.state_dir() / "web_endpoints.json"


def _load() -> dict:
    try:
        return json.loads(_path().read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def publish(tag: str, url: str) -> None:
    d = _load()
    d[tag] = url
    _path().write_text(json.dumps(d, indent=2))


def web_url_for(spec) -> str | None:
    d = _load()
    url = d.get(spec.tag)
    if url:
        return url
    # Not serving yet: return the deterministic URL serve would assign.
    label = (spec.web or {}).get("label") or spec.tag.split(".")[-1]
    return f"http://127.0.0.1:0/{label}"
