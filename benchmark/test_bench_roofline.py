"""The roofline counts against hand counts."""

import json
import os

import pytest

from benchmark import roofline

HERE = os.path.dirname(os.path.abspath(__file__))


def _encoder():
    with open(os.path.join(HERE, "configs", "cd_default_1card.json")) as f:
        return json.load(f)["encoder"]


def test_kernel_bound_at_the_main_path_shape():
    # 256 rows of 4096: 4,194,304 B of residuals + 1,024 of warm-ups +
    # 2,097,152 of tables = 6,292,480 B at 3.35 TB/s; 67,108,864 ops at 67 T
    assert roofline.kernel_bound_ms(256, 4096, 6) == pytest.approx(6292480 / 3.35e12 * 1e3)
    assert roofline.finest_order(4096) == 6 and roofline.finest_order(100) == 0


def test_forward_work_by_hand_at_a_small_shape():
    enc = _encoder()
    B, T = 2, 256
    K, P = 4, 1 << roofline.finest_order(T)
    # per block: M/S 3T; cascade 4*4T; ApproxEnt 4*5*(2T + 8*16); window 4T;
    # FIR 4*(2*10*T + 2T); two searches of 4 signals: zigzag 3T, tables
    # 64T, merges 3*P*32; argmins 4*(5+3) + 4
    per = (3 * T + 16 * T + 20 * (2 * T + 128) + 4 * T + 4 * 22 * T
           + 2 * 4 * (3 * T + 64 * T + 96 * P) + 32 + 4)
    f64 = 4 * (2 * 11 * (T - 10) + sum(7 * n + 6 for n in range(1, 10)))
    w = roofline.forward_work(B, 2, T, 16, enc)
    assert w == {"int_f32": B * per, "f64": B * f64,
                 "bytes": B * (2 * T * 2 + (1 + 2 * (5 + 24 + P)) * 4)}
    ms, cls = roofline.bound_ms(w)
    assert cls == "int_f32" and ms == pytest.approx(B * per / 67e12 * 1e3)


def test_forward_bound_at_the_cells():
    enc = _encoder()
    for batch in (64, 16):
        ms, cls = roofline.bound_ms(roofline.forward_work(batch, 2, 4096, 16, enc))
        # far below a forward's few milliseconds, and not set by the bytes
        assert 0 < ms < 0.01 and cls == "int_f32"
