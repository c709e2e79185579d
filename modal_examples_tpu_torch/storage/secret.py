"""Copy of ``modal_examples_tpu/storage/secret.py``: named env-var bundles injected into containers.

Reference spec: ``modal.Secret.from_name("huggingface-secret",
required_keys=["HF_TOKEN"])`` (openai_whisper/finetuning/train/train.py:27),
``Secret.from_dict({...})``, and ``Secret.from_local_environ``. Secrets attach
to Functions/Apps and materialize as environment variables inside the
container only.

Local control plane: JSON files under the state dir with 0600 permissions.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from .._internal import config as _config


class SecretNotFound(KeyError):
    pass


def _secrets_root() -> Path:
    p = _config.state_dir() / "secrets"
    p.mkdir(parents=True, exist_ok=True)
    return p


class Secret:
    def __init__(self, name: str, env: dict[str, str]):
        self.name = name
        self._env = dict(env)

    @classmethod
    def from_dict(cls, env: dict[str, str]) -> "Secret":
        return cls("anonymous", env)

    @classmethod
    def from_local_environ(cls, keys: list[str]) -> "Secret":
        missing = [k for k in keys if k not in os.environ]
        if missing:
            raise KeyError(f"missing local environment keys: {missing}")
        return cls("local-environ", {k: os.environ[k] for k in keys})

    @classmethod
    def from_name(
        cls, name: str, required_keys: list[str] | None = None, environment_name: str | None = None
    ) -> "Secret":
        path = _secrets_root() / f"{name}.json"
        if not path.exists():
            # Graceful degradation matching dev ergonomics: if the named
            # secret isn't registered but its required keys are present in
            # the local environment, synthesize it from there.
            if required_keys and all(k in os.environ for k in required_keys):
                return cls(name, {k: os.environ[k] for k in required_keys})
            raise SecretNotFound(
                f"secret {name!r} not found; create it with "
                f"`python -m modal_examples_tpu_torch secret create {name} KEY=VALUE ...`"
            )
        env = json.loads(path.read_text())
        if required_keys:
            missing = [k for k in required_keys if k not in env]
            if missing:
                raise KeyError(f"secret {name!r} missing required keys: {missing}")
        return cls(name, env)

    @staticmethod
    def create(name: str, env: dict[str, str], overwrite: bool = True) -> None:
        path = _secrets_root() / f"{name}.json"
        if path.exists() and not overwrite:
            raise FileExistsError(name)
        # create 0600 from the first byte — write_text-then-chmod leaves a
        # window where the plaintext is world-readable
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        # the mode arg only applies at creation: when overwriting a file that
        # already exists with looser permissions, tighten it too
        os.fchmod(fd, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(env))

    def env_vars(self) -> dict[str, str]:
        return dict(self._env)

    def __repr__(self) -> str:
        return f"Secret({self.name!r}, keys={sorted(self._env)})"
