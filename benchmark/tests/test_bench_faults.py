"""A whole run with the timed path broken underneath comes out not
correct, once for each fault a cell can have; unbroken, it is correct."""
import pytest

CELLS = ["cbr128.upload_encode", "cbr320.batch_decode",
         "cbr320.rendition_transcode"]


def run(cell):
    from mp3bench import main
    return main.measure(cell, 2 ** 31 + 11, 0.3, False, 0.0, device="cpu",
                        log=lambda s: None)


@pytest.mark.parametrize("workload", CELLS)
def test_faults_make_a_run_not_correct(small, workload):
    from mp3bench import faults
    cell = small(workload)
    assert run(cell)["correct"]
    for fault in faults.FAULTS:
        if not faults.applies(fault, cell.entry):
            continue
        with faults.plant(fault, cell.entry):
            r = run(cell)
        assert not r["correct"], (fault, r["checks"])
