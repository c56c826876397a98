"""``tools/sass_loop.py`` on the CPU: the hottest loop of a SASS dump (the
loop with the most instructions of its own, nested loops left out), its
opcodes and its instructions an element, read from a saved dump."""

import json

from ggml_cuda_experiments_tpu_torch.tools import sass_loop

# two functions in cuobjdump's layout: an outer loop around an inner one,
# and a function without a loop
DUMP = """
        Function : _Z6kernelPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IADD3 R2, R0, 0x1, RZ ;
        /*0030*/                   PRMT R3, R2, 0x7404, R4 ;
        /*0040*/                   FFMA R5, R3, R6, R7 ;
        /*0050*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;
        /*0060*/              @!P0 BRA 0x30 ;
        /*0070*/                   FADD R9, R9, R8 ;
        /*0080*/               @P1 BRA 0x20 ;
        /*0090*/                   EXIT ;
        Function : _Z5otherv
        /*0000*/                   EXIT ;
"""


def test_the_inner_loop_is_the_hottest():
    insns = sass_loop.functions(DUMP)["_Z6kernelPKf"]
    assert len(insns) == 10
    head, tail, body = sass_loop.hottest_loop(insns)
    # the inner loop 0x30-0x60 holds 4 of its own; the outer 0x20-0x80
    # holds 3 outside the inner one
    assert (head, tail) == (0x30, 0x60)
    assert [op for _, op, _ in body] == ["PRMT", "FFMA",
                                         "HMMA.16816.F32.BF16", "BRA"]


def test_report_counts_instructions_an_element(tmp_path, capsys):
    f = tmp_path / "dump.sass"
    f.write_text(DUMP)
    assert sass_loop.main(["--kernel", "kernel", "--elements", "2",
                           "--sass", str(f)]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])[
        "sass_loop"][0]
    assert row["body"] == 4 and row["per_element"] == 2.0
    assert row["by_opcode"] == {"PRMT": 1, "FFMA": 1, "HMMA": 1, "BRA": 1}
    assert sass_loop.main(["--kernel", "absent", "--elements", "1",
                           "--sass", str(f)]) == 1
