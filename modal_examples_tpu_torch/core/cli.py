"""The port's CLI, after ``modal_examples_tpu/core/cli.py`` (``tpurun``):
``run`` / ``deploy`` / ``serve`` / ``app`` / ``secret``, the analog of
``modal run`` etc.

Reference spec: ``modal run 01_getting_started/hello_world.py``
(README.md:17-21); auto-generated CLI flags from the ``local_entrypoint``
signature ("Arguments ... automatically get converted into CLI flags",
unsloth_finetune.py:356-360, 380-441); ``modal run --detach``
(long-training.py:168); ``modal deploy`` / ``modal serve``.

Usage:
    python -m modal_examples_tpu_torch run path/to/script.py [::entrypoint] [--flag value ...]
    python -m modal_examples_tpu_torch run --detach script.py
    python -m modal_examples_tpu_torch deploy script.py   # register + keep scheduler alive
    python -m modal_examples_tpu_torch serve script.py    # host web endpoints and servers
    python -m modal_examples_tpu_torch secret create NAME K=V ...
    python -m modal_examples_tpu_torch app list

The JAX package's other subcommands wait with their subsystems
(:data:`WAITING_COMMANDS`): each exits non-zero naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

from .._internal import config as _config

PROG = "python -m modal_examples_tpu_torch"


def _build_entrypoint_parser(fn, prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=fn.__doc__)
    sig = inspect.signature(fn)
    for name, param in sig.parameters.items():
        flag = "--" + name.replace("_", "-")
        ann = param.annotation
        required = param.default is inspect.Parameter.empty
        default = None if required else param.default
        if ann is bool or isinstance(default, bool):
            p.add_argument(
                flag,
                default=default if default is not None else False,
                action=argparse.BooleanOptionalAction,
            )
        else:
            typ = ann if ann in (int, float, str) else (type(default) if default is not None and type(default) in (int, float, str) else str)
            p.add_argument(flag, type=typ, default=default, required=required)
    return p


def _load_app(path: str):
    from .app import App, load_module_from_path

    module = load_module_from_path(path)
    apps = [v for v in vars(module).values() if isinstance(v, App)]
    if not apps:
        raise SystemExit(f"no App found in {path}")
    return module, apps[0]


def cmd_run(argv: list[str]) -> int:
    detach = False
    if argv and argv[0] == "--detach":
        detach = True
        argv = argv[1:]
    if not argv:
        raise SystemExit(f"usage: {PROG} run [--detach] script.py[::entrypoint] [flags]")
    target, *flags = argv
    ep_name = None
    if "::" in target:
        target, ep_name = target.split("::", 1)
    module, app = _load_app(target)
    if ep_name is None:
        if len(app.registered_entrypoints) == 1:
            ep_name = next(iter(app.registered_entrypoints))
        elif "main" in app.registered_entrypoints:
            ep_name = "main"
        elif app.registered_entrypoints:
            raise SystemExit(
                f"multiple entrypoints {sorted(app.registered_entrypoints)}; "
                f"pick one with script.py::name"
            )
    if ep_name is None:
        # no local_entrypoint: if exactly one registered function, invoke it
        if len(app.registered_functions) == 1:
            fn = next(iter(app.registered_functions.values()))
            with app.run(detach=detach):
                print(fn.remote())
            return 0
        raise SystemExit("no local_entrypoint found")
    ep = app.registered_entrypoints[ep_name]
    parser = _build_entrypoint_parser(ep.raw_f, prog=f"{PROG} run {target}")
    ns = parser.parse_args(flags)
    with app.run(detach=detach):
        ep.raw_f(**vars(ns))
    return 0


def cmd_deploy(argv: list[str]) -> int:
    keep_alive = "--no-scheduler" not in argv
    argv = [a for a in argv if a != "--no-scheduler"]
    if not argv:
        raise SystemExit(f"usage: {PROG} deploy script.py")
    path = argv[0]
    _module, app = _load_app(path)
    app.deploy(source_file=path)
    print(f"deployed app {app.name!r} "
          f"({len(app.registered_functions)} functions, "
          f"{len(app.registered_classes)} classes)")
    if keep_alive and app.scheduled_functions():
        print(f"scheduler running for {sorted(app.scheduled_functions())} (ctrl-c to stop)")
        try:
            app.run_scheduler()
        except KeyboardInterrupt:
            pass
    return 0


def cmd_serve(argv: list[str]) -> int:
    if not argv:
        raise SystemExit(f"usage: {PROG} serve script.py [--port N] [--timeout S]")
    path = argv[0]
    port = 0
    timeout = None
    if "--port" in argv:
        port = int(argv[argv.index("--port") + 1])
    if "--timeout" in argv:
        timeout = float(argv[argv.index("--timeout") + 1])
    elif os.environ.get("MTPU_SERVE_TIMEOUT"):
        # scripted-run bound, analog of MODAL_SERVE_TIMEOUT (run_example.py:28)
        timeout = float(os.environ["MTPU_SERVE_TIMEOUT"])
    _module, app = _load_app(path)
    from ..web.gateway import Gateway, wait_for_port

    with app.run():
        urls = []
        if app.registered_web_endpoints:
            gw = Gateway(app, port=port).start()
            urls += [f"{gw.base_url}/{label}" for label in gw.routes]
        for name, handle in getattr(app, "registered_servers", {}).items():
            urls.append(handle.serve())
        # @web_server(port) functions start their own server when invoked
        for name, fn in app.registered_functions.items():
            web = fn.spec.web or {}
            if web.get("type") == "web_server":
                fn.raw_f()  # user code binds the port (thread/subprocess)
                if wait_for_port("127.0.0.1", web["port"], web.get("startup_timeout", 30)):
                    urls.append(f"http://127.0.0.1:{web['port']}")
                else:
                    print(f"warning: {name} never opened port {web['port']}")
        if not urls:
            raise SystemExit("no web endpoints or servers registered")
        for u in urls:
            print(f"serving: {u}", flush=True)
        import time

        try:
            if timeout is None:
                while True:
                    time.sleep(3600)
            else:
                time.sleep(timeout)
        except KeyboardInterrupt:
            pass
    return 0


def cmd_secret(argv: list[str]) -> int:
    from ..storage.secret import Secret

    if len(argv) >= 2 and argv[0] == "create":
        name = argv[1]
        env = dict(kv.split("=", 1) for kv in argv[2:])
        Secret.create(name, env)
        print(f"secret {name!r} created with keys {sorted(env)}")
        return 0
    raise SystemExit(f"usage: {PROG} secret create NAME KEY=VALUE ...")


def cmd_app(argv: list[str]) -> int:
    if argv and argv[0] == "list":
        reg = _config.state_dir() / "apps.json"
        try:
            registry = json.loads(reg.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            registry = {}
        for name, entry in sorted(registry.items()):
            print(f"{name}\t{entry.get('source_file')}")
        return 0
    raise SystemExit(f"usage: {PROG} app list")


#: subcommands of the JAX package that wait with their subsystems:
#: name -> the ROADMAP item
WAITING_COMMANDS = {
    "examples": "A13 (the platform layer's rest)",
    "docs": "A13 (the platform layer's rest)",
    "snapshot": "A13 (snapshot/)",
    "trace": "A6 (observability/reqtrace.py's merged reads)",
    "explain": "A6 (observability/reqtrace.py's merged reads)",
    "benchdiff": "A8 (the port's benchmark)",
    "metrics": "A6 (observability/export.py)",
    "profile": "A6 (the profiler's ledger and CLI)",
    "usage": "A6 (the usage CLI)",
    "canary": "A6 (observability/canary.py)",
    "tsdb": "A6 (observability/timeseries.py)",
    "alerts": "A6 (observability/alerts.py)",
    "incidents": "A6 (observability/incident.py)",
    "incident": "A6 (observability/incident.py)",
    "scaler": "A6 (the observability CLI)",
    "sched": "A9 (scheduling/router.py)",
    "top": "A6 (observability/slo.py)",
    "disagg": "A9 (serving/disagg/)",
    "prefixstore": "A9 (serving/prefix_store/)",
    "chaos": "A9 (faults/chaos.py)",
    "fleet": "A9 (fleet/)",
    "health": "A9 (serving/health.py)",
}

COMMANDS = {
    "run": cmd_run,
    "deploy": cmd_deploy,
    "serve": cmd_serve,
    "secret": cmd_secret,
    "app": cmd_app,
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in WAITING_COMMANDS:
        raise SystemExit(
            f"{PROG} {cmd}: not in the port yet; it waits with ROADMAP "
            f"{WAITING_COMMANDS[cmd]}"
        )
    handler = COMMANDS.get(cmd)
    if handler is None:
        raise SystemExit(f"unknown command {cmd!r}; one of {sorted(COMMANDS)}")
    try:
        return handler(rest)
    except BrokenPipeError:
        # the reader closing the pipe early is success, not a traceback
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
