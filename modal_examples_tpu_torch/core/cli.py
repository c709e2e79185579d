"""The port's CLI, after ``modal_examples_tpu/core/cli.py`` (``tpurun``):
``run`` / ``deploy`` / ``serve`` / ``app`` / ``secret``, the analog of
``modal run`` etc., and the observability subcommands over the state
directory (traces, pushed metrics, the tsdb, alerts, incidents, the canary,
usage, the kernel build ledger, the autoscaler journal).

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
    python -m modal_examples_tpu_torch examples [list | run [pattern] [--timeout S]]
    python -m modal_examples_tpu_torch docs [OUT_DIR]         # render the literate examples
    python -m modal_examples_tpu_torch snapshot [list | inspect KEY | clear [KEY]] [--dir PATH]
    python -m modal_examples_tpu_torch trace [ID [--perfetto] | list [--limit N]]  # call/request traces
    python -m modal_examples_tpu_torch explain REQUEST_ID    # request lifecycle narrative
    python -m modal_examples_tpu_torch metrics [--json]      # merged pushed prometheus expositions
    python -m modal_examples_tpu_torch metrics --watch S [--rate]  # live tsdb deltas
    python -m modal_examples_tpu_torch profile [N] [--json]  # tick phases + the kernel build ledger
    python -m modal_examples_tpu_torch usage [N] [--json]    # per-tenant usage meters + MFU/MBU
    python -m modal_examples_tpu_torch canary [N] [--json]   # golden-set probe results + drift
    python -m modal_examples_tpu_torch tsdb [--series NAME]  # on-disk metrics history (MTPU_TSDB=1)
    python -m modal_examples_tpu_torch alerts [--last N]     # alert rules + fire/clear history
    python -m modal_examples_tpu_torch incidents [list|show|capture]  # incident bundles
    python -m modal_examples_tpu_torch scaler [N] [--function TAG]    # autoscaler decisions
    python -m modal_examples_tpu_torch top [--watch S]       # serving summary + SLO burn rates
    python -m modal_examples_tpu_torch sched [--watch S]     # queue depths, sheds, router affinity
    python -m modal_examples_tpu_torch disagg [--watch S]    # replica roles + page migrations
    python -m modal_examples_tpu_torch health [--last N]     # watchdog classification + ladder journal
    python -m modal_examples_tpu_torch prefixstore [--last N]  # shared prefix store: hits, dedup, takeovers
    python -m modal_examples_tpu_torch fleet [--last N]      # fleet autoscaler decisions + boot latency
    python -m modal_examples_tpu_torch chaos [--last N]      # chaos episodes + injected faults

The JAX package's ``benchdiff`` waits with the port's benchmark
(:data:`WAITING_COMMANDS`): it exits non-zero naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
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


_NEGATIVE_NUMBER = re.compile(r"^-\d+(\.\d+)?$")


def _pop_flag(
    argv: list[str], flag: str, usage: str
) -> tuple[list[str], str | None]:
    """Extract ``<flag> VALUE`` from argv; returns (rest, value_or_None).
    A flag present without its value — or followed by another flag-shaped
    token (``--x``/``-o``; negative numbers pass) — exits with ``usage``."""
    if flag not in argv:
        return argv, None
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise SystemExit(usage)
    value = argv[i + 1]
    if value.startswith("-") and not _NEGATIVE_NUMBER.match(value):
        raise SystemExit(usage)
    return argv[:i] + argv[i + 2 :], value


def _pop_dir_flag(argv: list[str], usage: str) -> tuple[list[str], str | None]:
    """Extract ``--dir PATH`` from argv; returns (rest, path_or_None)."""
    return _pop_flag(argv, "--dir", usage)


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


def cmd_examples(argv: list[str]) -> int:
    """List or run the example corpus (internal/run_example.py parity:
    subprocess per example with a timeout bound). ``run`` runs each example
    through this package's ``run``: an example written for the JAX package
    imports that package, and runs on it."""
    from ..utils.docs import get_examples, repo_root

    examples = get_examples()
    if not argv or argv[0] == "list":
        for e in examples:
            print(e.path)
        return 0
    if argv[0] == "run":
        import subprocess
        import tempfile

        timeout = 600.0
        cli_timeout = "--timeout" in argv
        if cli_timeout:
            timeout = float(argv[argv.index("--timeout") + 1])
        pattern = argv[1] if len(argv) > 1 and not argv[1].startswith("-") else ""
        targets = [e for e in examples if pattern in str(e.path)]
        if not targets:
            raise SystemExit(f"no examples match {pattern!r}")
        failures = []
        for e in targets:
            env = dict(os.environ)
            env.setdefault("MTPU_STATE_DIR", tempfile.mkdtemp(prefix="mtpu-ex-"))
            # cheap-mode defaults (the reference's frontmatter env overrides,
            # SURVEY §4): CI runs on CPU unless the caller opts into a chip
            env.setdefault("MTPU_TPU", "")
            for k, v in e.env.items():  # per-example frontmatter env
                env.setdefault(k, str(v))
            # precedence: explicit CLI flag > frontmatter > default
            eff_timeout = timeout if cli_timeout else (e.timeout or timeout)
            print(f"=== {e.path} ===", flush=True)
            try:
                proc = subprocess.run(
                    [sys.executable, "-m", "modal_examples_tpu_torch", "run",
                     str(repo_root() / e.path)],
                    timeout=eff_timeout,
                    env=env,
                )
                if proc.returncode != 0:
                    failures.append(str(e.path))
            except subprocess.TimeoutExpired:
                failures.append(f"{e.path} (timeout {eff_timeout}s)")
        if failures:
            print(f"FAILED ({len(failures)}/{len(targets)}):")
            for f in failures:
                print(" ", f)
            return 1
        print(f"all {len(targets)} example(s) passed")
        return 0
    raise SystemExit(f"usage: {PROG} examples [list | run [pattern] [--timeout S]]")


def cmd_docs(argv: list[str]) -> int:
    """Render the literate examples to markdown (the examples ARE the docs —
    internal/utils.py render_example_md parity)."""
    from pathlib import Path

    from ..utils.docs import get_examples, render_example_md, repo_root

    out_dir = Path(argv[0]) if argv else repo_root() / "docs"
    n = 0
    for e in get_examples():
        src = (repo_root() / e.path).read_text()
        md = render_example_md(src)
        target = out_dir / e.path.with_suffix(".md")
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(md)
        n += 1
    index = []
    # hand-written guides live next to the rendered examples; the index
    # links both so regeneration never clobbers the guide entries
    guides = sorted(
        p.name for p in out_dir.glob("*.md") if p.name != "index.md"
    )
    if guides:
        index.append("# Guides\n")
        for g in guides:
            title = g.removesuffix(".md").replace("_", " ")
            index.append(f"- [{title}]({g})")
        index.append("")
    index.append("# Examples\n")
    for e in get_examples():
        index.append(f"- [{e.module_name}]({e.path.with_suffix('.md')})")
    (out_dir / "index.md").write_text("\n".join(index) + "\n")
    print(f"rendered {n} example docs to {out_dir}")
    return 0


def cmd_snapshot(argv: list[str]) -> int:
    """Inspect the memory-snapshot store (modal_examples_tpu_torch.snapshot).

    list     — one line per entry: key, size, age, last use, function tag
    inspect  — full meta.json for one key (manifest, rebuild markers, ...)
    clear    — delete one entry (``clear KEY``) or every entry (``clear``)

    ``--dir PATH`` overrides the store root (default: MTPU_SNAPSHOT_DIR or
    ``<state_dir>/snapshots``).
    """
    from ..snapshot.store import SnapshotStore

    argv, root = _pop_dir_flag(argv, f"usage: {PROG} snapshot ... --dir PATH")
    store = SnapshotStore(root=root)
    sub = argv[0] if argv else "list"
    if sub == "list":
        entries = store.entries()
        if not entries:
            print(f"no snapshots in {store.root}")
            return 0
        import time as _time

        now = _time.time()
        print(f"{'KEY':<34} {'SIZE':>9} {'AGE':>8} {'USED':>8}  FUNCTION")
        for e in entries:
            size_kb = e.get("size_bytes", 0) / 1024
            age = now - e.get("created_at", now)
            used = now - e.get("last_used", now)
            tag = (e.get("manifest") or {}).get("tag", "")
            print(
                f"{e['key']:<34} {size_kb:>7.1f}kB {age:>7.0f}s {used:>7.0f}s  {tag}"
            )
        return 0
    if sub == "inspect":
        if len(argv) < 2:
            raise SystemExit(f"usage: {PROG} snapshot inspect KEY")
        meta = store.inspect(argv[1])
        if meta is None:
            raise SystemExit(f"no snapshot {argv[1]!r} in {store.root}")
        print(json.dumps(meta, indent=2))
        return 0
    if sub == "clear":
        if len(argv) >= 2:
            ok = store.delete(argv[1])
            print(f"{'deleted' if ok else 'no such entry'}: {argv[1]}")
            return 0 if ok else 1
        n = store.clear()
        print(f"cleared {n} snapshot(s) from {store.root}")
        return 0
    raise SystemExit(f"usage: {PROG} snapshot [list | inspect KEY | clear [KEY]] [--dir PATH]")


def cmd_trace(argv: list[str]) -> int:
    """Render one trace as an indented span tree — either id namespace:
    executor calls (``in-...``, ``FunctionCall.call_id``) and serving
    requests (``req-...``, ``x-mtpu-request-id``) live in the same store,
    and a unique id PREFIX resolves too.

    trace ID           — the spans of one call/request
    trace ID --perfetto [-o FILE] [--profile SNAP.json] [--tsdb]
                       — emit the trace as Chrome-trace/Perfetto JSON
                         (loads in chrome://tracing and ui.perfetto.dev;
                         request traces get one track per replica).
                         ``--profile`` merges a saved hot-path profiler
                         snapshot (the gateway's ``/profile`` payload, or
                         a bare {replica: {ticks, compiles}} map) as
                         tick-phase counter tracks + compile slices on
                         the owning replica tracks; ``--tsdb`` rides the
                         on-disk flight-recorder window overlapping the
                         spans along as counter tracks
    trace list [--limit N]
                       — most recently active traces, newest first
    ``--dir PATH`` overrides the trace root (default ``<state_dir>/traces``;
    ``os.pathsep``-separated roots merge per-replica stores, like explain).
    """
    from ..observability import reqtrace as _reqtrace
    from ..observability.trace import TraceStore

    argv, root = _pop_dir_flag(argv, "usage: python -m modal_examples_tpu_torch trace ... --dir PATH")
    stores = (
        [TraceStore(root=p) for p in root.split(os.pathsep) if p]
        if root
        else [TraceStore()]
    )
    store = stores[0]
    if not argv or argv[0] == "list":
        rest, limit_s = _pop_flag(
            argv[1:], "--limit", "usage: python -m modal_examples_tpu_torch trace list [--limit N]"
        )
        if limit_s is None and rest:  # bare N still accepted
            limit_s, rest = rest[0], rest[1:]
        limit = int(limit_s) if limit_s is not None else 20
        ids = store.list_traces(limit=limit)
        if not ids:
            print(f"no traces in {store.root}")
            return 0
        for tid in ids:
            spans = store.read(tid)
            roots = [s for s in spans if s.get("parent_id") is None]
            head = roots[0] if roots else (spans[0] if spans else {})
            attrs = head.get("attrs") or {}
            dur = (head.get("end") or 0) - (head.get("start") or 0)
            status = head.get("status", "?")
            print(
                f"{tid}  {attrs.get('function', '?'):<24} "
                f"{dur * 1000:>9.1f}ms  {status}  ({len(spans)} spans)"
            )
        return 0
    # by-id: resolve either namespace (whitelisted token, no raw-path
    # fallback) and MERGE the given stores — a per-replica-store fleet's
    # request trace renders/exports complete, not one store's slice
    trace_id = _reqtrace.resolve(argv[0], stores=stores)
    spans = _reqtrace.read_trace(trace_id, stores=stores) if trace_id else []
    if not spans:
        raise SystemExit(f"no trace {argv[0]!r} in {store.root}")
    if "--perfetto" in argv:
        from ..observability.export import spans_to_chrome_trace

        usage_p = (
            "usage: python -m modal_examples_tpu_torch trace ID --perfetto [-o FILE] "
            "[--profile SNAP.json] [--tsdb]"
        )
        argv, out_file = _pop_flag(argv, "-o", usage_p)
        argv, prof_file = _pop_flag(argv, "--profile", usage_p)
        with_tsdb = "--tsdb" in argv
        argv = [a for a in argv if a != "--tsdb"]
        tsdb = None
        if with_tsdb:
            # the on-disk flight-recorder window overlapping the spans
            # (±30 s) rides along as counter tracks next to the tick-phase
            # tracks (the reference's docs/observability.md#metrics-history)
            from ..observability import timeseries as _tsm

            at = [s.get("start") or 0.0 for s in spans]
            at += [s.get("end") or 0.0 for s in spans]
            at = [t for t in at if t]
            if at:
                tsdb = _tsm.read_window(min(at) - 30.0, max(at) + 30.0)
        profile = None
        if prof_file:
            from pathlib import Path as _Path

            doc_in = json.loads(_Path(prof_file).read_text())
            # accept the gateway's /profile payload or a bare
            # {replica: {ticks, compiles}} map
            nodes = doc_in.get("replicas", doc_in)
            profile = {
                name: node.get("perfetto", node)
                for name, node in nodes.items()
                if isinstance(node, dict)
            }
        doc = spans_to_chrome_trace(
            spans, trace_id, profile=profile, tsdb=tsdb
        )
        if out_file:
            from pathlib import Path as _Path

            _Path(out_file).write_text(json.dumps(doc, indent=1))
            print(
                f"wrote {len(doc['traceEvents'])} events to {out_file} "
                "(open in chrome://tracing or ui.perfetto.dev)"
            )
        else:
            print(json.dumps(doc))
        return 0
    spans.sort(key=lambda s: (s.get("start") or 0.0))
    by_parent: dict = {}
    for s in spans:
        by_parent.setdefault(s.get("parent_id"), []).append(s)
    t0 = min(s.get("start") or 0.0 for s in spans)

    def render(span: dict, depth: int) -> None:
        dur = ((span.get("end") or span["start"]) - span["start"]) * 1000
        rel = (span["start"] - t0) * 1000
        attrs = span.get("attrs") or {}
        extras = " ".join(f"{k}={v}" for k, v in attrs.items())
        mark = "" if span.get("status") == "ok" else f" [{span.get('status')}]"
        print(
            f"{'  ' * depth}{span['name']:<{24 - 2 * min(depth, 8)}} "
            f"+{rel:>8.1f}ms {dur:>9.1f}ms{mark}"
            + (f"  {extras}" if extras else "")
        )
        for child in by_parent.get(span.get("span_id"), []):
            render(child, depth + 1)

    print(f"trace {trace_id}")
    for s in by_parent.get(None, []):
        render(s, 0)
    # spans whose parent never landed (e.g. the container died before its
    # dispatch span closed) still print, flat, rather than vanishing
    known = {s.get("span_id") for s in spans}
    for s in spans:
        pid = s.get("parent_id")
        if pid is not None and pid not in known:
            render(s, 0)
    return 0


def cmd_explain(argv: list[str]) -> int:
    """Merge one request's spans across trace stores and render the
    lifecycle narrative (the reference's docs/observability.md):

        $ python -m modal_examples_tpu_torch explain req-4f2a...
        request req-4f2a...: serving request trace — stop in 412.0ms ...
          +   0.0ms  queued 12.1ms (class=interactive, replica dec-0)
          +  12.3ms  placed: prefill=pre-0 decode=dec-0
          +  13.0ms  prefill on pre-0 340.2ms (512 prompt tokens)
          ...

    Takes either id namespace — a serving request id (``req-…``, from the
    ``x-mtpu-request-id`` response header) or an executor call id
    (``in-…``) — full or unique prefix, and says which kind it found.
    ``--dir`` accepts one or more store roots (``os.pathsep``-separated)
    for merging per-replica trace dirs; default is ``<state_dir>/traces``.
    """
    from ..observability import reqtrace as _reqtrace
    from ..observability.trace import TraceStore

    usage = "usage: python -m modal_examples_tpu_torch explain REQUEST_ID [--dir PATH[:PATH...]]"
    argv, root = _pop_dir_flag(argv, usage)
    if not argv:
        raise SystemExit(usage)
    stores = (
        [TraceStore(root=p) for p in root.split(os.pathsep) if p]
        if root
        else None
    )
    rid = _reqtrace.resolve(argv[0], stores=stores)
    if rid is None:
        raise SystemExit(f"no trace matching {argv[0]!r}")
    spans = _reqtrace.read_trace(rid, stores=stores)
    for line in _reqtrace.explain_lines(spans, rid):
        print(line)
    return 0


def cmd_profile(argv: list[str]) -> int:
    """Hot-path time attribution (the reference's docs/observability.md#hot-path-profiling):
    the scheduler-tick phase table (p50/p95 per catalog.TICK_PHASES entry),
    the host-vs-device overhead fraction, and the compile ledger's biggest
    builds — from the pushed metrics files plus
    ``<state_dir>/compiles.jsonl``. Engines emit these series only under
    ``MTPU_PROFILE`` (bench configs opt in), so an empty table means no
    profiled engine has pushed yet. torch-free by construction.

    profile [N]        — phase table + top N ledger compiles (default 10)
    profile --json     — the machine-readable payload
    ``--dir PATH`` overrides the state-dir root (``metrics/`` +
    ``compiles.jsonl`` live under it).
    """
    from pathlib import Path

    from ..observability import catalog as C
    from ..observability import profiler as _prof
    from ..observability.export import pushed_jobs
    from ..utils.prometheus import merge_expositions, parse_exposition

    argv, root = _pop_dir_flag(argv, "usage: python -m modal_examples_tpu_torch profile [N] [--json]")
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    top_n = int(argv[0]) if argv else 10

    jobs = pushed_jobs(Path(root) / "metrics" if root else None)
    merged = parse_exposition(merge_expositions(jobs)) if jobs else None
    ledger = _prof.read_ledger(
        path=Path(root) / "compiles.jsonl" if root else None, n=2000
    )
    builds = [r for r in ledger if r.get("event") == "end"]
    unfinished = _prof.unfinished_builds(ledger)

    phases: dict = {}
    ratio = None
    decode_steps = None
    tokens_per_dispatch = None
    spec_gamma = None
    spec_accept = None
    spec_tpd = None
    lookups: dict = {}
    roofline: dict = {}
    if merged is not None:
        # roofline position (the reference's docs/observability.md#roofline-and-usage-
        # accounting): the usage meter's achieved-vs-peak gauges per phase
        for series, key in (
            (C.MFU, "mfu"),
            (C.HBM_BW_UTIL, "mbu"),
            (C.ACHIEVED_TFLOPS, "tflops"),
        ):
            for labels, v in merged.series(series):
                roofline.setdefault(labels.get("phase", "?"), {})[key] = v
        for phase in C.TICK_PHASES + (C.TICK_TOTAL_PHASE,):
            q = merged.histogram_quantiles(
                C.TICK_PHASE_SECONDS, quantiles=(0.5, 0.95),
                aggregate={"phase": phase},
            )
            if q:
                phases[phase] = {
                    "p50": q["p50"], "p95": q["p95"], "count": q["count"],
                }
        # a 0..1 fraction must never sum across jobs: show the worst
        ratio = merged.peak(C.HOST_OVERHEAD_RATIO) or None
        # macro-step decode (docs/multistep.md): configured N + the
        # harvested tokens-per-dispatch — gauges, so peak, never sum
        decode_steps = merged.peak(C.MULTISTEP_DECODE_STEPS) or None
        tokens_per_dispatch = (
            merged.peak(C.MULTISTEP_TOKENS_PER_DISPATCH) or None
        )
        # fused speculative rounds (docs/speculative.md#series): dispatched
        # γ p50 + acceptance — gauges, so peak, never sum
        spec_gamma = merged.peak(C.SPEC_GAMMA) or None
        spec_accept = merged.peak(C.SPEC_ACCEPTANCE_RATE) or None
        spec_tpd = merged.peak(C.SPEC_TOKENS_PER_DISPATCH) or None
        for labels, v in merged.series(C.COMPILES_TOTAL):
            entry = lookups.setdefault(
                labels.get("program", "?"), {"hit": 0, "miss": 0}
            )
            entry[labels.get("cache", "miss")] = int(v)

    top = sorted(
        builds, key=lambda r: r.get("seconds") or 0.0, reverse=True
    )[:top_n]
    if as_json:
        print(json.dumps({
            "host_overhead_ratio": ratio,
            "decode_steps": decode_steps,
            "tokens_per_dispatch": tokens_per_dispatch,
            "spec_gamma": spec_gamma,
            "spec_acceptance_rate": spec_accept,
            "spec_tokens_per_dispatch": spec_tpd,
            "roofline": roofline,
            "phases": phases,
            "compile_lookups": lookups,
            "compile_total_s": round(
                sum(r.get("seconds") or 0.0 for r in builds), 3
            ),
            "compiles_n": len(builds),
            "top_compiles": top,
            "unfinished_builds": unfinished,
        }))
        return 0

    if ratio is not None:
        print(f"host overhead ratio: {ratio:.3f} (1 - device-blocked/total)")
    if decode_steps is not None:
        tpd = (
            f"{tokens_per_dispatch:.1f}"
            if tokens_per_dispatch is not None else "-"
        )
        print(
            f"macro-step decode: N={decode_steps:.0f} configured, "
            f"{tpd} tokens/dispatch"
        )
    if spec_gamma is not None or spec_accept:
        acc = f"{spec_accept:.2f}" if spec_accept is not None else "-"
        stpd = f"{spec_tpd:.1f}" if spec_tpd is not None else "-"
        print(
            f"speculative decode: gamma p50 {spec_gamma or 0:.0f}, "
            f"acceptance {acc}, {stpd} tokens/round"
        )
    tot = roofline.get("total")
    if tot is not None:
        bound = (
            "compute-bound"
            if tot.get("mfu", 0.0) >= tot.get("mbu", 0.0)
            else "bandwidth-bound"
        )
        print(
            f"roofline: MFU {tot.get('mfu', 0.0):.4f}  "
            f"MBU {tot.get('mbu', 0.0):.4f}  "
            f"{tot.get('tflops', 0.0):.3f} TFLOP/s achieved ({bound})"
        )
    if phases:
        print(f"{'PHASE':<18} {'P50 ms':>9} {'P95 ms':>9} {'TICKS':>7}")
        for phase in list(C.TICK_PHASES) + [C.TICK_TOTAL_PHASE]:
            q = phases.get(phase)
            if q:
                print(
                    f"{phase:<18} {q['p50'] * 1000:>9.3f} "
                    f"{q['p95'] * 1000:>9.3f} {q['count']:>7}"
                )
    else:
        print(
            "no tick-phase series in pushed metrics "
            "(run a bench or an engine with MTPU_PROFILE=1 first)"
        )
    if lookups:
        print("\ncompile-cache lookups per program (miss=fresh build):")
        for program, entry in sorted(lookups.items()):
            print(
                f"  {program:<16} miss={entry['miss']:<5} hit={entry['hit']}"
            )
    if top:
        print(f"\ntop compiles ({len(builds)} ledgered builds):")
        for r in top:
            print(
                f"  {r.get('seconds', 0.0):>8.3f}s  "
                f"{r.get('program', '?'):<16} {r.get('shape_key', '?'):<14} "
                f"({r.get('replica', '?')})"
            )
    if unfinished:
        # the ≥40-slot ceiling diagnosis: a begin event with no end means
        # the build crashed or hung — name it loudly
        print("\nUNFINISHED builds (began, never completed — crash/hang?):")
        for r in unfinished:
            print(
                f"  {r.get('program', '?')} {r.get('shape_key', '?')} "
                f"on {r.get('replica', '?')}"
            )
    return 0


def cmd_usage(argv: list[str]) -> int:
    """Hardware-utilization accounting (the reference's docs/observability.md#roofline-and-
    usage-accounting): the per-tenant/per-class usage counters (prompt +
    generated tokens, device-seconds, KV page-seconds, sheds) from the
    pushed metrics files, the roofline MFU/MBU gauges, and the newest
    per-request records from ``<state_dir>/usage.jsonl``. torch-free by
    construction.

    usage [N]        — tenant table + last N journal records (default 10)
    usage --json     — the machine-readable payload
    ``--dir PATH`` overrides the state-dir root.
    """
    from pathlib import Path

    from ..observability import catalog as C
    from ..observability import usage as _usage
    from ..observability.export import pushed_jobs
    from ..observability.journal import named_journal
    from ..utils.prometheus import merge_expositions, parse_exposition

    argv, root = _pop_dir_flag(argv, "usage: python -m modal_examples_tpu_torch usage [N] [--json]")
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    last = int(argv[0]) if argv else 10

    jobs = pushed_jobs(Path(root) / "metrics" if root else None)
    merged = parse_exposition(merge_expositions(jobs)) if jobs else None

    tenants: dict = {}
    roofline: dict = {}
    if merged is not None:
        for series, field in (
            (C.USAGE_PROMPT_TOKENS_TOTAL, "prompt_tokens"),
            (C.USAGE_GENERATED_TOKENS_TOTAL, "generated_tokens"),
            (C.USAGE_DEVICE_SECONDS_TOTAL, "device_seconds"),
            (C.USAGE_KV_PAGE_SECONDS_TOTAL, "kv_page_seconds"),
            (C.USAGE_SHEDS_TOTAL, "sheds"),
        ):
            for labels, v in merged.series(series):
                key = (
                    labels.get("tenant", "?"), labels.get("class", "?")
                )
                tenants.setdefault(key, {})[field] = v
        for series, field in (
            (C.MFU, "mfu"),
            (C.HBM_BW_UTIL, "mbu"),
            (C.ACHIEVED_TFLOPS, "tflops"),
        ):
            for labels, v in merged.series(series):
                roofline.setdefault(
                    labels.get("phase", "?"), {}
                )[field] = v

    records = named_journal("usage", root).tail(last)
    journal_totals = _usage.journal_tenant_totals(records)

    if as_json:
        print(json.dumps({
            "tenants": [
                {"tenant": t, "class": k, **fields}
                for (t, k), fields in sorted(tenants.items())
            ],
            "roofline": roofline,
            "journal_totals": journal_totals,
            "records": records,
        }))
        return 0

    if tenants:
        print(
            f"{'TENANT':<14} {'CLASS':<13} {'PROMPT':>9} {'GEN':>8} "
            f"{'DEV s':>9} {'PAGE s':>11} {'SHEDS':>6}"
        )
        for (t, k), f in sorted(tenants.items()):
            print(
                f"{t:<14} {k:<13} {int(f.get('prompt_tokens', 0)):>9} "
                f"{int(f.get('generated_tokens', 0)):>8} "
                f"{f.get('device_seconds', 0.0):>9.3f} "
                f"{f.get('kv_page_seconds', 0.0):>11.3f} "
                f"{int(f.get('sheds', 0)):>6}"
            )
    else:
        print(
            "no usage series in pushed metrics "
            "(run a bench or a serving engine first)"
        )
    tot = roofline.get("total")
    if tot is not None:
        bound = (
            "compute-bound"
            if tot.get("mfu", 0.0) >= tot.get("mbu", 0.0)
            else "bandwidth-bound"
        )
        print(
            f"\nroofline: MFU {tot.get('mfu', 0.0):.4f}  "
            f"MBU {tot.get('mbu', 0.0):.4f}  "
            f"{tot.get('tflops', 0.0):.3f} TFLOP/s achieved ({bound})"
        )
    if records:
        print(f"\nlast {len(records)} usage records (usage.jsonl):")
        for r in records:
            print(
                f"  {r.get('request_id', '?'):<18} "
                f"{r.get('tenant', '?'):<12} {r.get('class', '?'):<10} "
                f"prompt={r.get('prompt_tokens', 0):<6} "
                f"gen={r.get('generated_tokens', 0):<6} "
                f"cached={r.get('cached_prompt_tokens', 0):<6} "
                f"{r.get('finish_reason', '?')}"
            )
    return 0


def cmd_canary(argv: list[str]) -> int:
    """Correctness-canary status
    (the reference's docs/observability.md#correctness-canary): per-replica golden-set
    probe counts from the pushed metrics files plus the newest probe
    rounds from ``<state_dir>/canary.jsonl``. torch-free by construction.

    canary [N]        — replica table + last N journal records (default 10)
    canary --json     — the machine-readable payload
    ``--dir PATH`` overrides the state-dir root.
    """
    from pathlib import Path

    from ..observability import catalog as C
    from ..observability.export import pushed_jobs
    from ..observability.journal import named_journal
    from ..utils.prometheus import merge_expositions, parse_exposition

    argv, root = _pop_dir_flag(argv, "usage: python -m modal_examples_tpu_torch canary [N] [--json]")
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    last = int(argv[0]) if argv else 10

    jobs = pushed_jobs(Path(root) / "metrics" if root else None)
    merged = parse_exposition(merge_expositions(jobs)) if jobs else None

    replicas: dict = {}
    if merged is not None:
        for labels, v in merged.series(C.CANARY_PROBES_TOTAL):
            rep = replicas.setdefault(labels.get("replica", "?"), {})
            rep[labels.get("result", "?")] = rep.get(
                labels.get("result", "?"), 0.0
            ) + v
        for labels, v in merged.series(C.CANARY_DRIFT_TOTAL):
            replicas.setdefault(
                labels.get("replica", "?"), {}
            )["drift_total"] = v
        for labels, v in merged.series(C.CANARY_FAILING):
            replicas.setdefault(
                labels.get("replica", "?"), {}
            )["failing_streak"] = v

    records = named_journal("canary", root).tail(last)

    if as_json:
        print(json.dumps({
            "replicas": [
                {"replica": name, **fields}
                for name, fields in sorted(replicas.items())
            ],
            "records": records,
        }))
        return 0

    if replicas:
        print(
            f"{'REPLICA':<18} {'PASS':>6} {'DRIFT':>6} {'ERROR':>6} "
            f"{'RECORDED':>9} {'STREAK':>7}"
        )
        for name, f in sorted(replicas.items()):
            print(
                f"{name:<18} {int(f.get('pass', 0)):>6} "
                f"{int(f.get('drift', 0)):>6} {int(f.get('error', 0)):>6} "
                f"{int(f.get('recorded', 0)):>9} "
                f"{int(f.get('failing_streak', 0)):>7}"
            )
    else:
        print(
            "no canary series in pushed metrics "
            "(arm the prober: MTPU_CANARY_INTERVAL, or run a bench)"
        )
    if records:
        print(f"\nlast {len(records)} canary records (canary.jsonl):")
        for r in records:
            action = r.get("action", "?")
            if action == "round":
                results = r.get("results", {})
                summary = " ".join(
                    f"{k}={v}" for k, v in sorted(results.items())
                )
                print(
                    f"  round      {r.get('replica', '?'):<16} {summary}"
                )
            else:
                print(
                    f"  {action:<10} {r.get('replica', '?'):<16} "
                    f"{r.get('reason', r.get('weight', ''))}"
                )
    return 0


def cmd_metrics(argv: list[str]) -> int:
    """Print the merged prometheus exposition of every pushed job file
    (``<state_dir>/metrics/*.prom`` — the local pushgateway) — the same text
    a scraper sees on the gateway's ``/metrics``. ``--json`` prints
    {job: path} of the sources instead.

    ``--watch S [--rate]`` switches to the flight recorder: live DELTAS
    from the on-disk tsdb (``<state_dir>/tsdb/``, written by any process
    running ``MTPU_TSDB=1``) refreshed every S seconds — each series'
    current value plus its change over the refresh window (``--rate``
    renders per-second rates instead), which a one-shot exposition dump
    structurally cannot show (the reference's docs/observability.md#metrics-history)."""
    from ..observability.export import _metrics_dir, read_pushed_metrics

    usage = "usage: python -m modal_examples_tpu_torch metrics [--json] [--watch S [--rate]] [--dir PATH]"
    argv, root = _pop_dir_flag(argv, usage)
    argv, watch_s = _pop_flag(argv, "--watch", usage)
    as_rate = "--rate" in argv
    argv = [a for a in argv if a != "--rate"]
    if watch_s is not None:
        return _metrics_watch(float(watch_s), root, as_rate)
    if "--json" in argv:
        d = _metrics_dir(root)
        print(json.dumps({p.stem: str(p) for p in sorted(d.glob("*.prom"))}))
        return 0
    text = read_pushed_metrics(root)
    if not text:
        print("no pushed metrics (run an app first, or scrape a live /metrics)")
        return 0
    print(text, end="")
    return 0


def _series_key(entry) -> str:
    name, labels = entry[0], entry[1]
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def _metrics_watch(watch: float, root, as_rate: bool) -> int:
    """The `python -m modal_examples_tpu_torch metrics --watch` loop: render the newest tsdb sample
    and the per-series delta (or rate) against the previous refresh."""
    import time as _time

    from ..observability import timeseries as _ts

    prev: dict | None = None
    try:
        while True:
            cur = _ts.read_latest(root=root)
            print("\033[2J\033[H", end="")
            if cur is None:
                print(
                    f"no tsdb samples under {_ts.tsdb_dir(root)} "
                    "(start an engine/bench with MTPU_TSDB=1)"
                )
                _time.sleep(watch)
                continue
            rows: list[tuple[str, float, float | None]] = []
            prev_vals = (
                {
                    _series_key(e): (e[3], e[4])
                    for e in prev.get("series", ())
                }
                if prev is not None
                else {}
            )
            dt = cur["at"] - prev["at"] if prev is not None else None
            for e in cur.get("series", ()):
                key = _series_key(e)
                value = e[3]
                delta = None
                if key in prev_vals and dt and dt > 0:
                    d = value - prev_vals[key][0]
                    delta = (d / dt) if as_rate else d
                rows.append((key, value, delta))
            moved = [r for r in rows if r[2]]
            still = [r for r in rows if not r[2]]
            when = _time.strftime(
                "%H:%M:%S", _time.localtime(cur["at"])
            )
            unit = "/s" if as_rate else f"/{dt:.1f}s" if dt else ""
            print(
                f"tsdb {_ts.tsdb_dir(root)}  sample {when}  "
                f"{len(rows)} series  (delta{unit or ': first sample'})"
            )
            print(f"{'SERIES':<56} {'VALUE':>12} {'DELTA':>12}")
            shown = 0
            for key, value, delta in (
                sorted(moved, key=lambda r: -abs(r[2])) + sorted(still)
            ):
                if shown >= 40:
                    hidden_moved = max(0, len(moved) - shown)
                    note = (
                        f"{hidden_moved} still changing"
                        if hidden_moved
                        else "unchanged"
                    )
                    print(f"… {len(rows) - shown} more ({note})")
                    break
                d = f"{delta:+.3f}" if delta is not None else "-"
                print(f"{key:<56} {value:>12.3f} {d:>12}")
                shown += 1
            prev = cur
            _time.sleep(watch)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_tsdb(argv: list[str]) -> int:
    """Metrics-history view of the on-disk tsdb segment ring
    (``<state_dir>/tsdb/``, the reference's docs/observability.md#metrics-history).

    tsdb                      — summary: segments, window covered, series
    tsdb --series NAME [--label k=v] [--window S] [--sum]
                              — (time, value) points for one series,
                                newest last; ``--sum`` reads a histogram's
                                cumulative seconds instead of its count
    tsdb --rate ...           — the per-second increase over the window
                                (counter-reset aware), instead of points
    tsdb --perfetto FILE [--window S]
                              — export the window's counter tracks as
                                Chrome-trace JSON (ui.perfetto.dev)
    tsdb --json               — machine-readable payload
    ``--dir PATH`` overrides the state-dir root.
    """
    from pathlib import Path

    from ..observability import timeseries as _ts

    usage = (
        "usage: python -m modal_examples_tpu_torch tsdb [--series NAME [--label k=v] [--sum] [--rate]]"
        " [--window S] [--perfetto FILE] [--json] [--dir PATH]"
    )
    argv, root = _pop_dir_flag(argv, usage)
    argv, series = _pop_flag(argv, "--series", usage)
    argv, label_s = _pop_flag(argv, "--label", usage)
    argv, window_s = _pop_flag(argv, "--window", usage)
    argv, perfetto = _pop_flag(argv, "--perfetto", usage)
    as_json = "--json" in argv
    as_rate = "--rate" in argv
    as_sum = "--sum" in argv

    labels = None
    if label_s:
        k, _, v = label_s.partition("=")
        labels = {k: v}

    records = _ts.read_window(root=root)
    if window_s is not None and records:
        lo = records[-1]["at"] - float(window_s)
        records = [r for r in records if r["at"] >= lo]
    if not records:
        print(
            f"no tsdb samples under {_ts.tsdb_dir(root)} "
            "(start an engine/bench with MTPU_TSDB=1)"
        )
        return 0

    if perfetto:
        from ..observability.export import spans_to_chrome_trace

        doc = spans_to_chrome_trace([], "tsdb-window", tsdb=records)
        Path(perfetto).write_text(json.dumps(doc, indent=1))
        print(
            f"wrote {perfetto} ({len(records)} samples as counter tracks "
            "— open in chrome://tracing or ui.perfetto.dev)"
        )
        return 0

    span = records[-1]["at"] - records[0]["at"]
    if series:
        pts = _ts.series_points(
            series, records, labels=labels,
            field="sum" if as_sum else "value",
        )
        if as_rate:
            r = _ts.rate(pts)
            if as_json:
                print(json.dumps({"series": series, "rate_per_s": r}))
            elif r is None:
                print(f"not enough points for a rate ({len(pts)} in window)")
            else:
                print(f"{series}: {r:.6f}/s over {span:.1f}s")
            return 0
        if as_json:
            print(json.dumps({"series": series, "points": pts}))
            return 0
        if not pts:
            print(f"no points for {series} in the window")
            return 0
        import time as _time

        for at, v in pts:
            when = _time.strftime("%H:%M:%S", _time.localtime(at))
            print(f"{when}  {v:.6f}")
        return 0

    names = _ts.series_names(records)
    if as_json:
        print(json.dumps({
            "dir": str(_ts.tsdb_dir(root)),
            "samples": len(records),
            "window_s": round(span, 3),
            "first_at": records[0]["at"],
            "last_at": records[-1]["at"],
            "series": names,
        }))
        return 0
    segs = sorted(_ts.tsdb_dir(root).glob("seg-*.jsonl"))
    print(
        f"{_ts.tsdb_dir(root)}: {len(segs)} segments, "
        f"{len(records)} samples covering {span:.1f}s, "
        f"{len(names)} series"
    )
    for name in names:
        print(f"  {name}")
    return 0


def cmd_alerts(argv: list[str]) -> int:
    """Alert rules + fire/clear history
    (the reference's docs/observability.md#alert-rules): the declarative rule set, each
    rule's condition evaluated one-shot over the on-disk tsdb window, and
    the newest transitions from the ``alerts`` journal.

    alerts [--last N]   — rule table + last N journal records (default 20)
    alerts --json       — machine-readable payload
    ``--dir PATH`` overrides the state-dir root.
    """
    from ..observability import alerts as _alerts
    from ..observability import timeseries as _ts

    usage = "usage: python -m modal_examples_tpu_torch alerts [--last N] [--json] [--dir PATH]"
    argv, root = _pop_dir_flag(argv, usage)
    argv, last_s = _pop_flag(argv, "--last", usage)
    last = int(last_s) if last_s is not None else 20
    as_json = "--json" in argv

    records = _ts.read_window(root=root)
    rows = _alerts.evaluate_offline(records)
    history = _alerts.read_alert_journal(last, root)
    if as_json:
        print(json.dumps({
            "rules": rows,
            "history": history,
            "tsdb_samples": len(records),
        }))
        return 0
    if not records:
        print(
            "no tsdb window to evaluate "
            "(start an engine/bench with MTPU_TSDB=1); rule set:"
        )
    print(
        f"{'RULE':<20} {'KIND':<10} {'SERIES':<32} {'THRESH':>7} "
        f"{'NOW':<5} DESCRIPTION"
    )
    for r in rows:
        now_s = "FIRE" if r["firing"] else "ok"
        print(
            f"{r['rule']:<20} {r['kind']:<10} {r['series']:<32} "
            f"{r['threshold']:>7} {now_s:<5} {r['description']}"
        )
    if history:
        import time as _time

        print()
        print(f"{'WHEN':<20} {'EVENT':<6} {'RULE':<20} VALUE")
        for rec in history:
            when = _time.strftime(
                "%Y-%m-%d %H:%M:%S", _time.localtime(rec.get("at", 0))
            )
            print(
                f"{when:<20} {rec.get('event', '?'):<6} "
                f"{rec.get('rule', '?'):<20} {rec.get('value')}"
            )
    return 0


def cmd_incidents(argv: list[str]) -> int:
    """Incident bundles (the reference's docs/observability.md#incident-bundles).

    incidents [list] [--json]    — bundle index, newest first
    incidents show ID [--file NAME]
                                 — one bundle's manifest (or one bundled
                                   file raw); a unique id prefix resolves
    incidents capture [--reason TEXT] [--trigger T]
                                 — capture a bundle right now (trigger
                                   ``manual``; ``revalidate_chip.sh``'s
                                   stage wrapper passes ``stage_failure``)
    ``--dir PATH`` overrides the state-dir root.
    """
    from ..observability import incident as _incident

    usage = (
        "usage: python -m modal_examples_tpu_torch incidents [list [--json] | show ID [--file NAME] "
        "| capture [--reason TEXT] [--trigger T]] [--dir PATH]"
    )
    argv, root = _pop_dir_flag(argv, usage)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    sub = argv[0] if argv else "list"

    if sub == "capture":
        argv, reason = _pop_flag(argv[1:], "--reason", usage)
        argv, trigger = _pop_flag(argv, "--trigger", usage)
        if trigger is not None and trigger not in _incident.TRIGGERS:
            raise SystemExit(
                f"unknown trigger {trigger!r}; one of {_incident.TRIGGERS}"
            )
        bundle = _incident.capture(
            trigger or "manual",
            reason=reason or "python -m modal_examples_tpu_torch incidents capture",
            root=root, force=True,
        )
        if bundle is None:
            print("capture failed (read-only state dir?)")
            return 1
        print(bundle)
        return 0

    if sub == "show":
        argv, file_name = _pop_flag(argv, "--file", usage)
        if len(argv) < 2:
            raise SystemExit(usage)
        manifest = _incident.read_manifest(argv[1], root=root)
        if manifest is None:
            raise SystemExit(f"no incident bundle {argv[1]!r}")
        if file_name:
            body = _incident.read_bundle_file(
                manifest["id"], file_name, root=root
            )
            if body is None:
                raise SystemExit(
                    f"no file {file_name!r} in {manifest['id']} "
                    f"(files: {sorted(manifest.get('files', {}))})"
                )
            print(body, end="")
            return 0
        print(json.dumps(manifest, indent=1))
        return 0

    if sub != "list":
        raise SystemExit(usage)
    manifests = _incident.list_incidents(root=root)
    if as_json:
        print(json.dumps(manifests))
        return 0
    if not manifests:
        print(f"no incident bundles under {_incident.incidents_dir(root)}")
        return 0
    import time as _time

    print(
        f"{'ID':<34} {'TRIGGER':<20} {'WHEN':<20} {'TSDB':>5} "
        f"{'TRACES':>6}  REASON"
    )
    for m in manifests:
        when = _time.strftime(
            "%Y-%m-%d %H:%M:%S", _time.localtime(m.get("at", 0))
        )
        print(
            f"{m.get('id', '?'):<34} {m.get('trigger', '?'):<20} "
            f"{when:<20} {m.get('tsdb_records', 0):>5} "
            f"{len(m.get('open_traces', ())):>6}  {m.get('reason', '')}"
        )
    return 0


def cmd_scaler(argv: list[str]) -> int:
    """Print the autoscaler decision journal, newest last.

    scaler [N]            — last N decisions (default 20)
    scaler --function TAG — only one function's decisions
    scaler --json         — raw JSONL records
    ``--dir PATH`` overrides the journal directory (default: state dir).
    """
    from ..observability.journal import named_journal

    argv, root = _pop_dir_flag(argv, "usage: python -m modal_examples_tpu_torch scaler ... --dir PATH")
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    argv, function = _pop_flag(
        argv, "--function", "usage: python -m modal_examples_tpu_torch scaler [N] [--function TAG]"
    )
    n = int(argv[0]) if argv else 20

    journal = named_journal("scaler", root)
    recs = journal.tail(n, function=function)
    if not recs:
        print(f"no autoscaler decisions in {journal.path}")
        return 0
    if as_json:
        for r in recs:
            print(json.dumps(r))
        return 0
    import time as _time

    print(
        f"{'WHEN':<20} {'FUNCTION':<24} {'ACTION':<11} {'TRIGGER':<17} "
        f"{'QUEUE':>5} {'POOL':>7}  DETAIL"
    )
    for r in recs:
        when = _time.strftime(
            "%Y-%m-%d %H:%M:%S", _time.localtime(r.get("at", 0))
        )
        pool = f"{r.get('containers_before', '?')}->{r.get('containers_after', '?')}"
        detail = []
        if r.get("spawned"):
            detail.append(f"spawned={r['spawned']}")
        if r.get("idle_ages_s"):
            detail.append(f"idle={r['idle_ages_s'][0]:.1f}s")
        if r.get("container") is not None:
            detail.append(f"container={r['container']}")
        print(
            f"{when:<20} {r.get('function', '?'):<24} "
            f"{r.get('action', '?'):<11} {r.get('trigger', '?'):<17} "
            f"{r.get('queue_depth', 0):>5} {pool:>7}  {' '.join(detail)}"
        )
    return 0


def cmd_top(argv: list[str]) -> int:
    """Live serving summary: engine load, token-level latency, SLO burn
    rates, and recent autoscaler decisions — from the pushed metrics files
    plus the decision journal (the ``htop`` of the framework).

    ``--watch S`` refreshes every S seconds until interrupted;
    ``--dir PATH`` overrides the state dir roots.
    """
    from ..observability import catalog as C
    from ..observability.export import pushed_jobs
    from ..observability.journal import named_journal
    from ..observability.slo import evaluate
    from ..serving.health import decode_watchdog_series
    from ..utils.prometheus import merge_expositions, parse_exposition

    usage = "usage: python -m modal_examples_tpu_torch top [--watch S] [--dir PATH]"
    argv, root = _pop_dir_flag(argv, usage)
    argv, watch_s = _pop_flag(argv, "--watch", usage)
    watch = float(watch_s) if watch_s is not None else None

    from pathlib import Path

    metrics_root = Path(root) / "metrics" if root else None
    journal = named_journal("scaler", root)

    def render() -> None:
        jobs = pushed_jobs(metrics_root)
        if not jobs:
            print("no pushed metrics yet (run an app or bench first)")
        merged = parse_exposition(merge_expositions(jobs))

        def fmt_q(name):
            q = merged.histogram_quantiles(
                name, quantiles=(0.5, 0.95), aggregate={}
            )
            if q is None:
                return "     -/-    "
            return f"{q['p50'] * 1000:>6.1f}/{q['p95'] * 1000:<6.1f}"

        print(f"jobs: {len(jobs)} ({', '.join(sorted(jobs)) or 'none'})")
        print(
            f"tokens/s {merged.total(C.TOKENS_PER_SECOND):>8.1f}   "
            f"active slots {merged.total(C.ACTIVE_SLOTS):>4.0f}   "
            f"waiting {merged.total(C.WAITING_REQUESTS):>4.0f}   "
            # a 0..1 fraction must never sum across jobs: show the worst
            f"kv occupancy {merged.peak(C.KV_PAGE_OCCUPANCY):>5.2f}"
        )
        print(
            f"ttft p50/p95 ms {fmt_q(C.TTFT_SECONDS)}   "
            f"tpot p50/p95 ms {fmt_q(C.TPOT_SECONDS)}"
        )
        # macro-step decode (docs/multistep.md): configured N + harvested
        # tokens-per-dispatch, when a multistep engine has pushed (gauges:
        # peak, never sum across jobs)
        ms_n = merged.peak(C.MULTISTEP_DECODE_STEPS)
        if ms_n:
            print(
                f"macro-step decode: N={ms_n:.0f}   tokens/dispatch "
                f"{merged.peak(C.MULTISTEP_TOKENS_PER_DISPATCH):.1f}"
            )
        # fused speculative decode (docs/speculative.md#series): dispatched
        # γ p50 + acceptance, when a spec engine has pushed (gauges: peak)
        sp_acc = merged.peak(C.SPEC_ACCEPTANCE_RATE)
        if merged.peak(C.SPEC_GAMMA) or sp_acc:
            print(
                f"speculative decode: gamma p50 "
                f"{merged.peak(C.SPEC_GAMMA):.0f}   acceptance "
                f"{sp_acc:.2f}   tokens/round "
                f"{merged.peak(C.SPEC_TOKENS_PER_DISPATCH):.1f}"
            )
        # the resolved decode plan, incl. the tensor-parallel degree and the
        # PER-SHARD ragged variant (paged_impl_plan(mesh=...)) — so a TP
        # deployment's dashboard shows the sharded plan actually running
        for labels, _v in merged.series(C.DECODE_IMPL):
            print(
                f"decode impl: attention={labels.get('attention', '?')} "
                f"variant={labels.get('variant', '-')} "
                f"scatter={labels.get('scatter', '?')} "
                f"kv_dtype={labels.get('kv_dtype', '?')} "
                f"tp={labels.get('tp', '1')}"
            )
        # the gray-failure watchdog: per-replica classification and
        # progress age, when a watchdog has pushed
        wd = decode_watchdog_series(merged)
        wd_states = wd["states"]
        if wd_states:
            wd_ages = wd["ages"]
            print(
                "replica health: "
                + "  ".join(
                    f"{name}={state}"
                    + (f"({wd_ages[name]:.1f}s)" if wd_ages.get(name) else "")
                    for name, state in sorted(wd_states.items())
                )
            )
        print()
        print(f"{'SLO':<22} {'TARGET':>10} {'OBSERVED':>10} {'BURN':>6}  OK")
        for r in evaluate(merged, burn_rate_registry=merged):
            obs = "-" if r["observed"] is None else f"{r['observed']:.4f}"
            burn = "-" if r["burn_rate"] is None else f"{r['burn_rate']:.2f}"
            print(
                f"{r['name']:<22} {r['target']:>10.4f} {obs:>10} {burn:>6}  "
                f"{'ok' if r['ok'] else 'VIOLATING'}"
            )
        recs = journal.tail(5)
        if recs:
            print()
            print("recent autoscaler decisions:")
            for r in recs:
                print(
                    f"  {r.get('function', '?')}: {r.get('action')} "
                    f"({r.get('trigger')}) queue={r.get('queue_depth')} "
                    f"pool {r.get('containers_before')}->"
                    f"{r.get('containers_after')}"
                )

    if watch is None:
        render()
        return 0
    import time as _time

    try:
        while True:
            print("\033[2J\033[H", end="")
            render()
            _time.sleep(watch)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_sched(argv: list[str]) -> int:
    """Live scheduler view: per-class queue depth + admission wait, shed
    rates by reason, deadline misses, and router affinity, from the pushed
    metrics files (the scheduling companion of ``top``).

    ``--watch S`` refreshes every S seconds; ``--dir PATH`` overrides the
    state dir root.
    """
    from ..observability import catalog as C
    from ..observability.export import pushed_jobs
    from ..scheduling.policy import PRIORITY_CLASSES
    from ..utils.prometheus import merge_expositions, parse_exposition

    usage = f"usage: {PROG} sched [--watch S] [--dir PATH]"
    argv, root = _pop_dir_flag(argv, usage)
    argv, watch_s = _pop_flag(argv, "--watch", usage)
    watch = float(watch_s) if watch_s is not None else None

    from pathlib import Path

    metrics_root = Path(root) / "metrics" if root else None

    def render() -> None:
        jobs = pushed_jobs(metrics_root)
        if not jobs:
            print("no pushed metrics yet (run an app or bench first)")
        merged = parse_exposition(merge_expositions(jobs))
        print(f"jobs: {len(jobs)} ({', '.join(sorted(jobs)) or 'none'})")
        print(
            f"{'CLASS':<13} {'QUEUED':>6} {'ADMITTED':>9} {'SHED':>6} "
            f"{'WAIT p50/p95 ms':>18}"
        )
        for klass in PRIORITY_CLASSES:
            depth = merged.total(C.SCHED_QUEUE_DEPTH, {"class": klass})
            admitted = merged.total(
                C.REQUESTS_ADMITTED_TOTAL, {"class": klass}
            )
            shed = merged.total(C.SHEDS_TOTAL, {"class": klass})
            q = merged.histogram_quantiles(
                C.SCHED_QUEUE_WAIT_SECONDS,
                quantiles=(0.5, 0.95),
                aggregate={"class": klass},
            )
            wait = (
                f"{q['p50'] * 1000:>7.1f}/{q['p95'] * 1000:<7.1f}"
                if q
                else "      -/-     "
            )
            print(
                f"{klass:<13} {depth:>6.0f} {admitted:>9.0f} {shed:>6.0f} "
                f"{wait:>18}"
            )
        offered = merged.total(C.REQUESTS_ADMITTED_TOTAL) + merged.total(
            C.SHEDS_TOTAL
        )
        shed_rate = (
            merged.total(C.SHEDS_TOTAL) / offered if offered else 0.0
        )
        by_reason = {}
        for lbls, v in merged.series(C.SHEDS_TOTAL):
            reason = lbls.get("reason", "?")
            by_reason[reason] = by_reason.get(reason, 0.0) + v
        reasons = " ".join(
            f"{r}={int(v)}" for r, v in sorted(by_reason.items())
        )
        print(
            f"shed rate {shed_rate:.4f}"
            + (f"   by reason: {reasons}" if reasons else "")
        )
        misses = {
            lbls.get("stage", "?"): v
            for lbls, v in merged.series(C.DEADLINE_MISSES_TOTAL)
        }
        if misses:
            print(
                "deadline misses: "
                + " ".join(f"{k}={int(v)}" for k, v in sorted(misses.items()))
            )
        routed = merged.total(C.ROUTER_REQUESTS_TOTAL)
        if routed:
            print(
                f"router: {int(routed)} placed, "
                f"{int(merged.total(C.ROUTER_AFFINITY_HITS_TOTAL))} affinity "
                f"hits, "
                f"{int(merged.total(C.ROUTER_REQUESTS_TOTAL, {'route': 'fallback'}))}"
                f" fallbacks"
            )

    if watch is None:
        render()
        return 0
    import time as _time

    try:
        while True:
            print("\033[2J\033[H", end="")
            render()
            _time.sleep(watch)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_disagg(argv: list[str]) -> int:
    """Live disaggregated-serving view: replica roles and the outstanding
    and completed migrations (wire bytes, chunk retries, latency
    quantiles), from the pushed metrics files (the disagg companion of
    ``sched``), and the tiered prefix cache's per-tier occupancy and hits.

    ``--watch S`` refreshes every S seconds; ``--dir PATH`` overrides the
    state dir root.
    """
    from ..observability import catalog as C
    from ..observability.export import pushed_jobs
    from ..utils.prometheus import merge_expositions, parse_exposition

    usage = f"usage: {PROG} disagg [--watch S] [--dir PATH]"
    argv, root = _pop_dir_flag(argv, usage)
    argv, watch_s = _pop_flag(argv, "--watch", usage)
    watch = float(watch_s) if watch_s is not None else None

    from pathlib import Path

    metrics_root = Path(root) / "metrics" if root else None

    def render() -> None:
        jobs = pushed_jobs(metrics_root)
        if not jobs:
            print("no pushed metrics yet (run an app or bench first)")
        merged = parse_exposition(merge_expositions(jobs))
        print(f"jobs: {len(jobs)} ({', '.join(sorted(jobs)) or 'none'})")
        roles = sorted(
            (lbls.get("replica", "?"), lbls.get("role", "?"))
            for lbls, v in merged.series(C.REPLICA_ROLE)
            if v
        )
        if roles:
            print(f"{'REPLICA':<24} ROLE")
            for name, role in roles:
                print(f"{name:<24} {role}")
        else:
            print("no role-tagged replicas (unified fleet)")
        by_result = {
            lbls.get("result", "?"): v
            for lbls, v in merged.series(C.DISAGG_MIGRATIONS_TOTAL)
        }
        inflight = merged.total(C.DISAGG_MIGRATIONS_INFLIGHT)
        q = merged.histogram_quantiles(
            C.DISAGG_MIGRATION_SECONDS, quantiles=(0.5, 0.95), aggregate={}
        )
        lat = (
            f"{q['p50'] * 1000:.1f}/{q['p95'] * 1000:.1f} ms"
            if q
            else "-/-"
        )
        print(
            f"migrations: {int(sum(by_result.values()))} total "
            f"({' '.join(f'{k}={int(v)}' for k, v in sorted(by_result.items())) or 'none'})"
            f"   inflight {int(inflight)}"
        )
        print(
            f"  pages {int(merged.total(C.DISAGG_PAGES_MIGRATED_TOTAL))}   "
            f"wire bytes {int(merged.total(C.DISAGG_MIGRATION_BYTES_TOTAL))}   "
            f"chunk retries "
            f"{int(merged.total(C.DISAGG_CHUNK_RETRIES_TOTAL))}   "
            f"latency p50/p95 {lat}"
        )
        hits = {
            lbls.get("tier", "?"): v
            for lbls, v in merged.series(C.PREFIX_TIER_HITS_TOTAL)
        }
        total_hits = sum(hits.values())
        print()
        print(f"{'TIER':<8} {'BLOCKS':>8} {'BYTES':>12} {'HITS':>8} {'RATE':>6}")
        for tier in ("hbm", "host", "volume"):
            pages = merged.total(C.PREFIX_TIER_PAGES, {"tier": tier})
            tier_bytes = merged.total(C.PREFIX_TIER_BYTES, {"tier": tier})
            h = hits.get(tier, 0.0)
            rate = h / total_hits if total_hits else 0.0
            occ = "-" if tier == "hbm" else f"{int(pages)}"
            occ_b = "-" if tier == "hbm" else f"{int(tier_bytes)}"
            print(
                f"{tier:<8} {occ:>8} {occ_b:>12} {int(h):>8} {rate:>6.2f}"
            )


    if watch is None:
        render()
        return 0
    import time as _time

    try:
        while True:
            print("\033[2J\033[H", end="")
            render()
            _time.sleep(watch)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_health(argv: list[str]) -> int:
    """Gray-failure watchdog view: per-replica progress classification,
    watermark ages, ladder counters, and the last N watchdog decisions from
    the journal (``<state_dir>/watchdog.jsonl``) plus the pushed watchdog
    metric series.

    ``--last N`` shows the newest N journal records (default 20);
    ``--dir PATH`` overrides the state dir root.
    """
    from pathlib import Path

    from ..observability.export import pushed_jobs
    from ..observability.journal import named_journal
    from ..serving.health import decode_watchdog_series
    from ..utils.prometheus import merge_expositions, parse_exposition

    usage = f"usage: {PROG} health [--last N] [--dir PATH]"
    argv, root = _pop_dir_flag(argv, usage)
    argv, last_s = _pop_flag(argv, "--last", usage)
    last = int(last_s) if last_s is not None else 20

    records = named_journal("watchdog", root).tail(last)

    jobs = pushed_jobs(Path(root) / "metrics" if root else None)
    merged = parse_exposition(merge_expositions(jobs)) if jobs else None

    wd = (
        decode_watchdog_series(merged)
        if merged is not None
        else {"states": {}, "ages": {}, "transitions": {}, "recoveries": {}}
    )
    states, ages = wd["states"], wd["ages"]
    transitions, recoveries = wd["transitions"], wd["recoveries"]

    if not records and not states:
        print(
            "no watchdog activity recorded yet "
            "(run a FleetWatchdog over a router's replicas)"
        )
        return 0
    if states:
        print(f"{'REPLICA':<16} {'STATE':<12} {'PROGRESS AGE':>12}")
        for name in sorted(states):
            age = ages.get(name)
            print(
                f"{name:<16} {states[name]:<12} "
                f"{('%.2fs' % age) if age is not None else '-':>12}"
            )
    if transitions:
        print(
            "transitions: "
            + "  ".join(
                f"{k}={int(v)}" for k, v in sorted(transitions.items())
            )
        )
    if recoveries:
        print(
            "ladder actions: "
            + "  ".join(
                f"{k}={int(v)}" for k, v in sorted(recoveries.items())
            )
        )
    if records:
        print()
        print(f"{'ACTION':<16} {'REPLICA':<16} DETAIL")
        for rec in records:
            action = rec.get("action", "?")
            who = rec.get("replica") or rec.get("transfer_id") or "?"
            if action == "transition":
                detail = (
                    f"-> {rec.get('state')} (raw={rec.get('raw')}, "
                    f"age={rec.get('progress_age_s')}s, "
                    f"outstanding={rec.get('outstanding')})"
                )
            elif action == "down_weight":
                detail = f"weight={rec.get('weight')}"
            elif action == "quarantine":
                detail = f"for {rec.get('quarantine_s')}s"
            elif action == "abort_transfer":
                detail = f"stalled > {rec.get('stall_s')}s"
            else:
                detail = ""
            print(f"{action:<16} {who:<16} {detail}")
    return 0


def cmd_chaos(argv: list[str]) -> int:
    """Chaos-harness view: the last fault-injection episodes (faults
    injected per catalog point, recoveries, and invariant results) from
    the chaos journal (``<state_dir>/chaos.jsonl``) plus pushed metrics
    (the fault-injection companion of ``disagg``).

    ``--last N`` shows the newest N episodes (default 10); ``--dir PATH``
    overrides the state dir root.
    """
    from pathlib import Path

    from ..observability import catalog as C
    from ..observability.export import pushed_jobs
    from ..observability.journal import named_journal
    from ..utils.prometheus import merge_expositions, parse_exposition

    usage = f"usage: {PROG} chaos [--last N] [--dir PATH]"
    argv, root = _pop_dir_flag(argv, usage)
    argv, last_s = _pop_flag(argv, "--last", usage)
    last = int(last_s) if last_s is not None else 10

    episodes = named_journal("chaos", root).tail(last)

    # per-point injected totals: pushed metrics when available (the chaos
    # runner pushes job "chaos"), else aggregated from the journal records
    jobs = pushed_jobs(Path(root) / "metrics" if root else None)
    injected: dict[str, float] = {}
    if jobs:
        merged = parse_exposition(merge_expositions(jobs))
        for lbls, v in merged.series(C.FAULTS_INJECTED_TOTAL):
            injected[lbls.get("point", "?")] = v
        readmissions = merged.total(C.ROUTER_READMISSIONS_TOTAL)
    else:
        readmissions = 0.0
    if not injected:
        for ep in episodes:
            for point, n in (ep.get("injected") or {}).items():
                injected[point] = injected.get(point, 0) + n

    if not episodes and not injected:
        print(
            "no chaos episodes recorded yet "
            "(run `python -m pytest tests/test_torch_chaos.py` or "
            "faults.chaos.run_chaos first)"
        )
        return 0
    if injected:
        print(f"{'FAULT POINT':<28} {'INJECTED':>9}")
        for point in sorted(injected):
            print(f"{point:<28} {int(injected[point]):>9}")
        print(f"{'total':<28} {int(sum(injected.values())):>9}")
    if readmissions:
        print(f"router re-admissions: {int(readmissions)}")
    if episodes:
        print()
        print(
            f"{'EPISODE':<20} {'INJ':>4} {'FINISHED':<24} {'SHED':>4} "
            f"{'WEDGED':>6} INVARIANTS"
        )
        for ep in episodes:
            finished = " ".join(
                f"{k}={v}" for k, v in sorted(
                    (ep.get("finished") or {}).items()
                )
            )
            inv = ep.get("invariants")
            print(
                f"{ep.get('episode', '?'):<20} "
                f"{sum((ep.get('injected') or {}).values()):>4} "
                f"{finished:<24} {ep.get('shed', 0):>4} "
                f"{ep.get('wedged', 0):>6} "
                f"{'ok' if inv == 'ok' else f'VIOLATED: {inv}'}"
            )
    return 0


def cmd_prefixstore(argv: list[str]) -> int:
    """Shared prefix-store view: fleet-wide dedup ratio, hit origins
    (self vs peer — peer hits are the cross-replica wins the store
    exists for), resident bytes, and the lease-takeover journal tail,
    from the pushed metrics files plus ``<state_dir>/prefix_store.jsonl``
    (the shared-KV companion of ``disagg``).

    ``--last N`` shows the newest N journal records (default 10);
    ``--dir PATH`` overrides the state dir root.
    """
    from pathlib import Path

    from ..observability import catalog as C
    from ..observability.export import pushed_jobs
    from ..observability.journal import named_journal
    from ..utils.prometheus import merge_expositions, parse_exposition

    usage = f"usage: {PROG} prefixstore [--last N] [--dir PATH]"
    argv, root = _pop_dir_flag(argv, usage)
    argv, last_s = _pop_flag(argv, "--last", usage)
    last = int(last_s) if last_s is not None else 10

    jobs = pushed_jobs(Path(root) / "metrics" if root else None)
    records = named_journal("prefix_store", root).tail(last)
    if not jobs and not records:
        print(
            "no shared prefix-store activity yet "
            "(serve with tiered_prefix shared=True, or run the chaos "
            "runner first)"
        )
        return 0

    if jobs:
        merged = parse_exposition(merge_expositions(jobs))
        hits = {
            lbls.get("origin", "?"): v
            for lbls, v in merged.series(C.PREFIX_STORE_HITS_TOTAL)
        }
        total_hits = sum(hits.values())
        misses = merged.total(C.PREFIX_STORE_MISSES_TOTAL)
        looked = total_hits + misses
        print(f"jobs: {len(jobs)} ({', '.join(sorted(jobs)) or 'none'})")
        print(
            f"hits: {int(total_hits)} "
            f"(self={int(hits.get('self', 0))} "
            f"peer={int(hits.get('peer', 0))})   "
            f"misses {int(misses)}   "
            f"hit rate {total_hits / looked if looked else 0.0:.2f}"
        )
        print(
            f"dedup ratio {merged.total(C.PREFIX_STORE_DEDUP_RATIO):.2f}   "
            f"resident bytes "
            f"{int(merged.total(C.PREFIX_STORE_BYTES))}   "
            f"owner takeovers "
            f"{int(merged.total(C.PREFIX_STORE_OWNER_TAKEOVERS_TOTAL))}"
        )
    if records:
        print()
        print(f"{'ACTION':<16} {'CHAIN':<14} {'FROM':<12} {'TO':<12} REASON")
        for rec in records:
            print(
                f"{rec.get('action', '?'):<16} "
                f"{str(rec.get('chain', '?'))[:12]:<14} "
                f"{str(rec.get('from', '-')):<12} "
                f"{str(rec.get('to', '-')):<12} "
                f"{rec.get('reason', '-')}"
            )
    return 0


def cmd_fleet(argv: list[str]) -> int:
    """Fleet-autoscaler view: replica counts by role, scale decisions by
    action/trigger, boot latency (warm snapshot-restore vs cold init), and
    the newest decision-journal records (``<state_dir>/fleet.jsonl``):
    the replica-fleet companion of ``scaler``.

    ``--last N`` shows the newest N journal records (default 20);
    ``--dir PATH`` overrides the state dir root.
    """
    from pathlib import Path

    from ..observability import catalog as C
    from ..observability.export import pushed_jobs
    from ..observability.journal import named_journal
    from ..utils.prometheus import merge_expositions, parse_exposition

    usage = f"usage: {PROG} fleet [--last N] [--dir PATH]"
    argv, root = _pop_dir_flag(argv, usage)
    argv, last_s = _pop_flag(argv, "--last", usage)
    last = int(last_s) if last_s is not None else 20

    journal = named_journal("fleet", root)
    records = journal.tail(last)

    jobs = pushed_jobs(Path(root) / "metrics" if root else None)
    merged = parse_exposition(merge_expositions(jobs)) if jobs else None

    replicas: dict[str, float] = {}
    decisions: dict[tuple[str, str], float] = {}
    if merged is not None:
        for lbls, v in merged.series(C.FLEET_REPLICAS):
            replicas[lbls.get("role", "?")] = v
        for lbls, v in merged.series(C.FLEET_DECISIONS_TOTAL):
            decisions[(lbls.get("action", "?"), lbls.get("trigger", "?"))] = v
    if not decisions:
        # no pushed metrics: aggregate over the WHOLE journal (its own
        # file bound), not the --last display window — the counts table
        # prints as totals and must not be silently capped at N
        for rec in journal.tail(1 << 20):
            key = (rec.get("action", "?"), rec.get("trigger", "?"))
            decisions[key] = decisions.get(key, 0) + 1

    if not records and not decisions:
        print(
            "no fleet decisions recorded yet "
            "(run a FleetAutoscaler first)"
        )
        return 0
    if replicas:
        print("replicas: " + "  ".join(
            f"{role}={int(n)}" for role, n in sorted(replicas.items()) if n
        ))
    if decisions:
        print(f"{'ACTION':<12} {'TRIGGER':<16} {'COUNT':>6}")
        for (action, trigger), n in sorted(decisions.items()):
            print(f"{action:<12} {trigger:<16} {int(n):>6}")
    if merged is not None:
        for boot in ("warm", "cold"):
            q = merged.histogram_quantiles(
                C.FLEET_BOOT_SECONDS, quantiles=(0.5, 0.95),
                aggregate={"boot": boot},
            )
            if q:
                print(
                    f"{boot} boots: p50 {q['p50'] * 1000:.0f} ms   "
                    f"p95 {q['p95'] * 1000:.0f} ms"
                )
    if records:
        print()
        print(
            f"{'ACTION':<12} {'ROLE':<8} {'REPLICA':<14} {'TRIGGER':<16} "
            f"{'BOOT':<6} {'N->N':>7}"
        )
        for rec in records:
            boot = rec.get("boot") or "-"
            before = rec.get("replicas_before")
            after = rec.get("replicas_after")
            sizes = f"{before}->{after}" if before is not None else "-"
            print(
                f"{rec.get('action', '?'):<12} {rec.get('role', '?'):<8} "
                f"{rec.get('replica', '?'):<14} {rec.get('trigger', '?'):<16} "
                f"{boot:<6} {sizes:>7}"
            )
    return 0


#: subcommands of the JAX package that wait with their subsystems:
#: name -> the ROADMAP item
WAITING_COMMANDS = {
    "benchdiff": "A8 (the port's benchmark)",
}

COMMANDS = {
    "run": cmd_run,
    "deploy": cmd_deploy,
    "serve": cmd_serve,
    "secret": cmd_secret,
    "app": cmd_app,
    "examples": cmd_examples,
    "docs": cmd_docs,
    "snapshot": cmd_snapshot,
    "trace": cmd_trace,
    "explain": cmd_explain,
    "metrics": cmd_metrics,
    "profile": cmd_profile,
    "usage": cmd_usage,
    "canary": cmd_canary,
    "tsdb": cmd_tsdb,
    "alerts": cmd_alerts,
    "incidents": cmd_incidents,
    "incident": cmd_incidents,  # `incident capture` reads naturally
    "scaler": cmd_scaler,
    "top": cmd_top,
    "sched": cmd_sched,
    "disagg": cmd_disagg,
    "health": cmd_health,
    "prefixstore": cmd_prefixstore,
    "chaos": cmd_chaos,
    "fleet": cmd_fleet,
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
