"""Copy of ``modal_examples_tpu/utils/docs.py``: literate-example tooling,
discovery and markdown rendering.

Reference parity (SURVEY.md §4): examples ARE the docs — `# `-prefixed
comment blocks render to markdown with code in fences
(internal/utils.py:46-84 render_example_md); discovery walks the numbered
example dirs (internal/utils.py:153-161).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

_SKIP_DIRS = {"internal", "misc", "__pycache__"}


@dataclasses.dataclass
class Example:
    path: Path
    module_name: str
    category: str  # e.g. "01_getting_started"
    # frontmatter knobs (the reference's jupytext frontmatter — cmd/env/
    # timeout per example, internal/utils.py:115-140): a leading block of
    #   # ---
    #   # env: {"MTPU_TRAIN_STEPS": "300"}
    #   # timeout: 800
    #   # ---
    # sets per-example cheap-mode env defaults and the runner's bound
    env: dict = dataclasses.field(default_factory=dict)
    timeout: float | None = None

    @property
    def repo_relative(self) -> str:
        return str(self.path)


def _parse_frontmatter(py: Path) -> tuple[dict, float | None]:
    """Read the optional leading `# ---` frontmatter block."""
    import json

    env: dict = {}
    timeout = None
    try:
        lines = py.read_text().splitlines()[:12]
    except OSError:
        return env, timeout
    if not lines or lines[0].strip() != "# ---":
        return env, timeout
    for line in lines[1:]:
        stripped = line.strip()
        if stripped == "# ---":
            break
        if stripped.startswith("# env:"):
            try:
                parsed = json.loads(stripped[len("# env:"):].strip())
            except json.JSONDecodeError:
                parsed = None
            if isinstance(parsed, dict):
                env = parsed
        elif stripped.startswith("# timeout:"):
            try:
                timeout = float(stripped[len("# timeout:"):].strip())
            except ValueError:
                pass
    return env, timeout


def repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def get_examples(root: Path | None = None) -> list[Example]:
    """Walk the numbered example dirs, skipping internal/ and misc/."""
    root = root or (repo_root() / "examples")
    out: list[Example] = []
    if not root.exists():
        return out
    for cat_dir in sorted(root.iterdir()):
        if not cat_dir.is_dir() or cat_dir.name in _SKIP_DIRS:
            continue
        for py in sorted(cat_dir.rglob("*.py")):
            if py.name.startswith("_") or "__pycache__" in py.parts:
                continue
            env, timeout = _parse_frontmatter(py)
            out.append(
                Example(
                    path=py.relative_to(root.parent),
                    module_name=py.stem,
                    category=cat_dir.name,
                    env=env,
                    timeout=timeout,
                )
            )
    return out


def render_example_md(source: str) -> str:
    """Render a literate example: `# ` comment blocks become prose, code
    becomes fenced blocks. The `# # Title` convention maps to headings.
    A leading frontmatter block (`# ---` ... `# ---`) is metadata for the
    example runner, not prose — stripped before rendering (the reference's
    renderer does the same with its jupytext frontmatter)."""
    lines = source.splitlines()
    if lines and lines[0].strip() == "# ---":
        for i in range(1, min(len(lines), 12)):
            if lines[i].strip() == "# ---":
                lines = lines[i + 1:]
                break
    out: list[str] = []
    code_buf: list[str] = []

    def flush_code():
        while code_buf and not code_buf[0].strip():
            code_buf.pop(0)
        while code_buf and not code_buf[-1].strip():
            code_buf.pop()
        if code_buf:
            out.append("```python")
            out.extend(code_buf)
            out.append("```")
            code_buf.clear()

    for line in lines:
        m = re.match(r"^# ?(.*)$", line)
        if m and not line.startswith("#!"):
            flush_code()
            out.append(m.group(1))
        else:
            code_buf.append(line)
    flush_code()
    return "\n".join(out).strip() + "\n"
