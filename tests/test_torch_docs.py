"""The port's literate-example tooling (``utils/docs.py``) and its
``examples`` and ``docs`` subcommands held against the JAX package's: the
example index (paths, categories, frontmatter), the markdown of every
example, and what each subcommand prints and writes.
"""

import dataclasses

import pytest

from modal_examples_tpu.core import cli as jcli
from modal_examples_tpu.utils import docs as jdocs
from modal_examples_tpu_torch.core import cli as pcli
from modal_examples_tpu_torch.utils import docs as pdocs
from test_torch_time_limit import share_cores, time_limits

share_cores()

#: the corpus's sixty examples rendered (a second or two)
_limit_module, _limit_test = time_limits(test_s=60, module_s=120)

CATEGORIES = sorted({e.category for e in jdocs.get_examples()})


def test_repo_root_is_the_references():
    assert pdocs.repo_root() == jdocs.repo_root()
    assert (pdocs.repo_root() / "examples").is_dir()


def test_get_examples_equals_the_references():
    port, ref = pdocs.get_examples(), jdocs.get_examples()
    assert [dataclasses.asdict(e) for e in port] == [dataclasses.asdict(e) for e in ref]
    assert len(port) > 40 and any(e.env or e.timeout for e in port)  # frontmatter read


@pytest.mark.parametrize("category", CATEGORIES)
def test_render_example_md_equals_the_references(category):
    for e in pdocs.get_examples():
        if e.category == category:
            src = (pdocs.repo_root() / e.path).read_text()
            assert pdocs.render_example_md(src) == jdocs.render_example_md(src), e.path


@pytest.mark.parametrize("source", [
    "# ---\n# env: {\"A\": \"1\"}\n# timeout: 5\n# ---\n# # Title\n\nx = 1\n",
    "#!/usr/bin/env python\n# prose\ncode()\n\n\n# more prose\n",
    "",
    "# only prose\n",
    "x = 1  # trailing comment is code\n",
])
def test_render_edge_cases_equal_the_references(source):
    assert pdocs.render_example_md(source) == jdocs.render_example_md(source)


def test_frontmatter_parse_equals_the_references(tmp_path):
    cases = {
        "ok.py": '# ---\n# env: {"MTPU_TRAIN_STEPS": "3"}\n# timeout: 80\n# ---\nx = 1\n',
        "bad_env.py": "# ---\n# env: not json\n# timeout: soon\n# ---\n",
        "none.py": "x = 1\n",
    }
    root = tmp_path / "examples" / "01_cat"
    root.mkdir(parents=True)
    for name, text in cases.items():
        (root / name).write_text(text)
    (root / "_private.py").write_text("skipped\n")
    port = pdocs.get_examples(tmp_path / "examples")
    ref = jdocs.get_examples(tmp_path / "examples")
    assert [dataclasses.asdict(e) for e in port] == [dataclasses.asdict(e) for e in ref]
    assert {e.module_name: (e.env, e.timeout) for e in port} == {
        "ok": ({"MTPU_TRAIN_STEPS": "3"}, 80.0), "bad_env": ({}, None), "none": ({}, None)}


def test_examples_list_prints_the_references(capsys):
    assert pcli.main(["examples", "list"]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["examples"]) == 0
    assert port == capsys.readouterr().out
    assert port.count("\n") == len(jdocs.get_examples())


def test_examples_run_without_a_match_exits_naming_the_pattern():
    with pytest.raises(SystemExit, match="no examples match 'no-such-example'"):
        pcli.main(["examples", "run", "no-such-example"])


def test_docs_writes_and_prints_the_references(tmp_path, capsys):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for d in ("port", "jax"):  # a hand-written guide beside the rendered examples
        (tmp_path / d / "my_guide.md").write_text("# guide\n")
    assert pcli.main(["docs", str(tmp_path / "port")]) == 0
    port_out = capsys.readouterr().out
    assert jcli.main(["docs", str(tmp_path / "jax")]) == 0
    assert port_out.replace("port", "X") == capsys.readouterr().out.replace("jax", "X")

    def files(d):
        return {str(p.relative_to(d)): p.read_text() for p in sorted(d.rglob("*.md"))}

    port, ref = files(tmp_path / "port"), files(tmp_path / "jax")
    assert port == ref
    assert "[my guide](my_guide.md)" in port["index.md"] and len(port) == len(jdocs.get_examples()) + 2
