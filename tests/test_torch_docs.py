"""The fenced ``python`` blocks of README's ``## PyTorch/CUDA port``
section run on the CPU, in order, in one namespace, as the docs lane runs a
whole file (``tools/check_doc_snippets.py``, whose ``python_blocks`` finds
them). ``tests/test_docs.py`` runs the README from its first block and
stops at the first failure, which lies before this section (ROADMAP C5),
so these blocks are run here on their own.
"""
import importlib.util
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SECTION = "## PyTorch/CUDA port"


def _python_blocks():
    spec = importlib.util.spec_from_file_location(
        "check_doc_snippets", os.path.join(ROOT, "tools",
                                           "check_doc_snippets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.python_blocks


def _section_blocks() -> list:
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as f:
        text = f.read()
    start = text.index("\n" + SECTION + "\n")
    end = text.find("\n## ", start + 1)
    offset = text[:start + 1].count("\n")
    return [(line + offset, src) for line, src in
            _python_blocks()(text[start + 1:end if end > 0 else None])]


BLOCKS = _section_blocks()


@pytest.fixture(scope="module")
def namespace():
    return {"__name__": "docsnippets:README.md"}


def test_the_section_has_python_blocks():
    assert len(BLOCKS) >= 2


@pytest.mark.parametrize("index", range(len(BLOCKS)))
def test_port_readme_block_runs(index, namespace):
    """Block ``index`` runs after the blocks before it, in their
    namespace (a block whose predecessor failed fails too)."""
    ran = namespace.setdefault("__ran__", 0)
    assert ran == index, f"block {ran} did not run"
    line, src = BLOCKS[index]
    exec(compile(src, f"README.md block {index} of the port section "
                 f"(line {line})",
                 "exec"), namespace)
    namespace["__ran__"] = index + 1
