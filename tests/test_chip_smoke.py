"""chip_smoke.py on the CPU: it refuses to report without a GPU, and its
phase functions pass against their references at rehearsal size."""

import numpy as np
import pytest

import chip_smoke as cs


def test_refuses_cpu_backend(capsys):
    from vecgo.utils.device import NoAccelerator, device_info

    with pytest.raises(NoAccelerator):
        device_info(expect_gpu=True)
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_exact_reference_matches_brute_force():
    from vecgo.utils import testutil as tu

    x, q, _, _ = cs.make_data(3000, 16, 32, 8, 0.25, seed=5)
    _, want = tu.brute_force_knn(q, x, cs.K)
    rows = np.arange(0, 3000, 3)
    _, want_f = tu.brute_force_knn(q, x[rows], cs.K)
    assert (cs.exact_topk(q, x, cs.K, chunk=700) == want).all()
    assert (cs.exact_topk(q, x, cs.K, rows=rows, chunk=256) == rows[want_f]).all()


def test_phases_pass_at_rehearsal_size(tmp_path, capsys):
    run = cs.Run(cs.TINY, "cpu", str(tmp_path))
    for name, fn in (
        ("1_ingest", cs.phase_ingest), ("2_flat", cs.phase_flat),
        ("3_filtered", cs.phase_filtered), ("4_graph", cs.phase_graph),
        ("5_hybrid", cs.phase_hybrid), ("6_coded", cs.phase_coded),
    ):
        run.phase(name, fn)
    run.db.close()
    assert run.failed == []
    assert run.results["2_flat_bf16"]["recall"] >= cs.RECALL_EXACT
    assert run.results["6_coded_scan"]["same_rows"] > 0.99
    assert '"ok"' not in capsys.readouterr().out
