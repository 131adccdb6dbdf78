"""The Pallas Triton coded-scan kernel against the XLA scan: interpret mode
on the CPU, compiled on a GPU (`gpu` marker; chip_smoke.py phase 6 runs the
same comparison at serving size)."""

import numpy as np
import pytest

from vecgo.utils import testutil as tu


@pytest.fixture(scope="module")
def coded():
    import jax.numpy as jnp

    from vecgo.ops import ivf

    x, _ = tu.clustered_vectors(6000, 32, n_clusters=24, seed=11)
    rng = np.random.default_rng(12)
    q = x[rng.choice(len(x), 48, replace=False)] + 0.02 * rng.standard_normal(
        (48, 32)
    ).astype(np.float32)
    _, members = ivf.build_ivf_table(x, capacity=192, seed=5)
    table = ivf.device_table_coded(members, jnp.asarray(x))
    row_mask = np.zeros(len(x), bool)
    row_mask[::4] = True
    mask = ivf.slot_mask_from_rows(table, jnp.asarray(row_mask)).reshape(-1)
    return jnp.asarray(q), table, mask


def _compare(q, table, mask, interpret, kk=8):
    from vecgo.ops import coded_scan_triton as tk
    from vecgo.ops import ivf

    probes = ivf._probe_clusters(q, table, 4)
    want_d, want_r = ivf._scan_groups_xla(
        q, table, probes, mask, kk=kk, qcap=24, group=8
    )
    got_d, got_r = tk.scan_groups(
        q, table, probes, mask, kk=kk, qcap=24, interpret=interpret
    )
    want_r, got_r = np.asarray(want_r), np.asarray(got_r)
    assert (want_r == got_r).mean() > 0.99
    fin = np.isfinite(np.asarray(want_d))
    np.testing.assert_allclose(
        np.asarray(got_d)[fin], np.asarray(want_d)[fin], rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize(
    "masked,kk", [(False, 8), (True, 8), (False, 12)],
    ids=["nomask", "mask", "kk12"],
)
def test_triton_coded_scan_interpret_matches_xla(coded, masked, kk):
    q, table, mask = coded
    _compare(q, table, mask if masked else None, interpret=True, kk=kk)


def test_scan_routing_follows_platform_and_width(coded, monkeypatch):
    """The kernel serves coded tables on a GPU at power-of-two widths; the
    XLA scan serves everything else (here: the CPU backend)."""
    from vecgo.ops import ivf

    _, table, _ = coded
    assert not ivf._triton_scan_applies(table, 32)  # CPU backend
    monkeypatch.setattr(ivf.jax, "default_backend", lambda: "gpu")
    assert ivf._triton_scan_applies(table, 32)
    assert not ivf._triton_scan_applies(table, 48)  # not a power of two
    assert not ivf._triton_scan_applies(table, 8)  # below a tensor tile
    dense = ivf.IVFDeviceTable(*[None] * 5)
    assert not ivf._triton_scan_applies(dense, 32)  # bf16 table: XLA


@pytest.mark.gpu
@pytest.mark.parametrize("kk", [8, 12])
def test_triton_coded_scan_compiled_matches_xla(coded, gpu_device, kk):
    q, table, mask = coded
    _compare(q, table, mask, interpret=False, kk=kk)
