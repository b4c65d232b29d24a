"""`debugger.program_to_code` / `draw_program` in the port: the same text
as the JAX package's for the same model built in both packages (a
GPT-2-style LM with its Adam update, seq2seq over LoD inputs, and a
program with `while` / `ifelse` sub-blocks), and the dot file written
where asked. A grad op's `fwd_op_id` attr is a process-wide counter,
which two packages in one process advance differently; the listings
are compared with it read as the forward op's place in its block."""

import re

import pytest

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
import paddle_tpu_torch as pt
from test_torch_proto_io import _both, _control_flow, _lm, _seq2seq


@pytest.fixture(autouse=True)
def _fresh():
    for P in (jpt, pt):
        P.framework.reset_default_programs()


def _code(P, prog):
    """program_to_code with each fwd_op_id as its op's index."""
    where = {op.id: i for blk in prog.blocks
             for i, op in enumerate(blk.ops)}
    return re.sub(r"fwd_op_id=(\d+)",
                  lambda m: f"fwd_op_id=@{where[int(m.group(1))]}",
                  P.debugger.program_to_code(prog))


@pytest.mark.parametrize("build", [_lm, _seq2seq, _control_flow],
                         ids=["lm", "seq2seq", "while_ifelse"])
def test_text_equals_the_reference(build, tmp_path):
    progs = _both(build)
    codes = []
    for i in (0, 1):
        jprog, pprog = progs[jpt][i], progs[pt][i]
        code = _code(pt, pprog)
        assert code == _code(jpt, jprog)
        codes.append(code)
        path = str(tmp_path / f"p{i}.dot")
        dot = pt.debugger.draw_program(pprog, path=path, name=f"p{i}")
        assert dot == jpt.debugger.draw_program(jprog, name=f"p{i}")
        with open(path) as f:
            assert f.read() == dot
    if build is _control_flow:
        assert "// block 3 (parent 0)" in codes[0]
