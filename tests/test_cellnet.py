import os

import numpy as np
import pytest

from bbtools_tpu.ml import CellNet, parse_bbnet, save_bbnet

REF_NET = "/root/reference/resources/bbmerge.bbnet"


def test_forward_hand_computed():
    # 2-1 net: out = sig(0.5 + 1*x0 - 2*x1)
    net = CellNet(
        dims=[2, 1],
        weights=[np.array([[1.0, -2.0]], np.float32)],
        biases=[np.array([0.5], np.float32)],
        types=[np.array([0], np.int32)],
    )
    out = net.apply(np.array([[1.0, 1.0], [0.0, 0.0]], np.float32))
    want = 1 / (1 + np.exp(-np.array([-0.5, 0.5])))
    np.testing.assert_allclose(out[:, 0], want, rtol=1e-5)


def test_activation_types():
    x = np.array([[0.7]], np.float32)
    for tname, fn in [
        ("TANH", np.tanh),
        ("RSLOG", lambda v: np.sign(v) * np.log(abs(v) + 1)),
        ("SWISH", lambda v: v / (1 + np.exp(-v))),
        ("ESIG", lambda v: 2 / (1 + np.exp(-v)) - 1),
        ("BELL", lambda v: np.exp(-v * v)),
        ("LINEAR", lambda v: v),
    ]:
        from bbtools_tpu.ml.cellnet import TYPES

        net = CellNet(
            dims=[1, 1],
            weights=[np.array([[1.0]], np.float32)],
            biases=[np.array([0.0], np.float32)],
            types=[np.array([TYPES.index(tname)], np.int32)],
        )
        got = float(net.apply(x)[0, 0])
        assert abs(got - fn(0.7)) < 1e-5, (tname, got, fn(0.7))


def test_train_xor():
    net = CellNet.create([2, 8, 1], seed=1, hidden="TANH")
    x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
    y = np.array([[0], [1], [1], [0]], np.float32)
    loss = net.fit(x, y, epochs=1500, lr=0.05)
    assert loss < 0.02, loss
    pred = net.apply(x)[:, 0]
    assert (pred.round() == y[:, 0]).all(), pred


def test_bbnet_roundtrip(tmp_path):
    net = CellNet.create([3, 5, 2], seed=2)
    net.cutoff = 0.42
    p = str(tmp_path / "x.bbnet")
    save_bbnet(net, p)
    net2 = parse_bbnet(p)
    assert net2.dims == [3, 5, 2]
    assert abs(net2.cutoff - 0.42) < 1e-6
    x = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(net.apply(x), net2.apply(x), atol=1e-5)


@pytest.mark.skipif(not os.path.exists(REF_NET), reason="no reference data")
def test_parse_reference_bbmerge_net():
    net = parse_bbnet(REF_NET)
    assert net.dims == [23, 96, 40, 56, 9, 1]
    assert abs(net.cutoff - 0.872857) < 1e-5
    x = np.zeros((2, 23), np.float32)
    x[1] = 0.5
    out = net.apply(x)
    assert out.shape == (2, 1)
    assert np.isfinite(out).all()
    assert (out >= -1).all() and (out <= 2).all()


def test_reference_bbnet_parses():
    """The bundled reference net must parse with its exact geometry and
    stored classification cutoff (##ctf line)."""
    import os

    import numpy as np

    from bbtools_tpu.ml.cellnet import parse_bbnet

    path = os.path.join(
        os.path.dirname(__file__), "..", "bbtools_tpu", "resources",
        "bbmerge.bbnet",
    )
    net = parse_bbnet(path)
    assert net.dims == [23, 96, 40, 56, 9, 1]
    assert abs(net.cutoff - 0.872857) < 1e-6
    out = net.apply(np.zeros((3, 23), np.float32))
    assert out.shape == (3, 1)
    assert np.allclose(out, out[0])  # deterministic


def test_bbmerge_nn_gate_discriminates():
    """The net gate must reject wrong-insert overlap signatures (many
    mismatches) and pass long clean overlaps — and nn=t must actually
    change merge decisions."""
    import os

    import numpy as np

    from bbtools_tpu.ml.cellnet import parse_bbnet
    from bbtools_tpu.ops.overlap import bbmerge_nn_features

    path = os.path.join(
        os.path.dirname(__file__), "..", "bbtools_tpu", "resources",
        "bbmerge.bbnet",
    )
    net = parse_bbnet(path)

    def stats(bo, bi, bb):
        z = np.zeros(1)
        return {
            "best_insert": z + bi, "best_overlap": z + bo,
            "best_bad": (z + 0.95 * bb).astype(np.float32),
            "best_ratio": (z + (0.95 * bb + 0.55) / bo).astype(np.float32),
            "best_bad_int": z + bb,
            "second_insert": z - 1, "second_overlap": z - 1,
            "second_bad": (z + 150.0).astype(np.float32),
            "second_ratio": (z + 1.0).astype(np.float32),
            "second_bad_int": z - 1,
        }

    al = np.array([150.0], np.float32)
    ee = np.array([0.047], np.float32)
    good = bbmerge_nn_features(
        al, al, np.array([12.0], np.float32), ee, ee, stats(100, 200, 0),
        np.array([0.03], np.float32), np.array([0.97], np.float32),
    )
    wrong = bbmerge_nn_features(
        al, al, np.array([12.0], np.float32), ee, ee, stats(100, 200, 25),
        np.array([0.03], np.float32), np.array([1e-5], np.float32),
    )
    sg = float(net.apply(good)[0, 0])
    sw = float(net.apply(wrong)[0, 0])
    assert sg >= net.cutoff, sg
    assert sw < 0.2, sw


def test_bbmerge_nn_flag_changes_decisions(tmp_path):
    import numpy as np

    from bbtools_tpu.io.fasta import load_reference, write_fasta
    from bbtools_tpu.models.bbmerge import BBMerge, parse_args
    from bbtools_tpu.utils.synth import random_genome, random_reads, write_reads

    g = random_genome(20_000, seed=33)
    write_fasta(str(tmp_path / "g.fa"), g)
    ref = load_reference(str(tmp_path / "g.fa"))
    pairs = random_reads(ref, 150, read_len=100, paired=True,
                         insert_range=(120, 170), snp_rate=0.0, seed=6)
    write_reads(str(tmp_path / "x1.fq"), [p[0] for p in pairs])
    write_reads(str(tmp_path / "x2.fq"), [p[1] for p in pairs])
    base = [f"in1={tmp_path}/x1.fq", f"in2={tmp_path}/x2.fq"]
    t_off = BBMerge(parse_args(base + [f"out={tmp_path}/a.fq"]))
    t_off.run()
    t_on = BBMerge(parse_args(base + [f"out={tmp_path}/b.fq", "nn=t"]))
    t_on.run()
    assert t_on.net is not None
    assert t_off.merged > 0
    assert t_on.merged != t_off.merged  # the gate measurably acts
    assert t_on.merged > 0  # but does not kill everything
