"""The algorithm's work from shapes, against counts worked out by hand."""

import pytest

from bench import readers, run, work

SPEC = run.load_json(run.ROOT / "BENCHMARK.json")


def _cell(name):
    cell, config, traffic = run.find_cell(SPEC, name)
    return traffic["entry"], config, traffic


def test_projection_bound_rsvd():
    # A 4096 x 4096 f32 read once (67,108,864 B) and Y 4096 x 266 written
    # once (4,358,144 B): 71,467,008 B / 3.35e12 B/s = 21.3334 us; the
    # 8,925,478,912 operations take 9.0248 us at 989 TFLOP/s: bytes bound.
    entry, config, traffic = _cell("rsvd.fused")
    assert work.sketches(entry, config, traffic) == [(4096, 4096, 266)]
    assert work.projection_bound_per_decomp_s(entry, config, traffic) == \
        pytest.approx(71_467_008 / 3.35e12)
    assert work.gemm_flops(4096, 4096, 266) == 8_925_478_912


def test_projection_bound_hosvd():
    # each mode: 256 x 65536 f32 (67,108,864 B) + Y 256 x 32 (32,768 B) =
    # 67,141,632 B -> 20.0423 us, three times; the 1,073,741,824
    # operations take 1.0857 us at 989 TFLOP/s: bytes bound.
    entry, config, traffic = _cell("hosvd.fused")
    assert work.sketches(entry, config, traffic) == [(256, 65536, 32)] * 3
    assert work.projection_bound_per_decomp_s(entry, config, traffic) == \
        pytest.approx(3 * 67_141_632 / 3.35e12)


def test_projection_bound_sthosvd():
    # modes on 256^3, then 32 x 256 x 256, then 32 x 32 x 256:
    # 67,141,632 + (8,388,608 + 32,768) + (1,048,576 + 32,768) B
    entry, config, traffic = _cell("hosvd.st")
    assert work.sketches(entry, config, traffic) == [
        (256, 65536, 32), (256, 8192, 32), (256, 1024, 32)]
    assert work.projection_bound_per_decomp_s(entry, config, traffic) == \
        pytest.approx((67_141_632 + 8_421_376 + 1_081_344) / 3.35e12)


def test_decomp_flops_rsvd():
    # Y = A Omega 2*4096*4096*266 = 8,925,478,912; QR of 4096 x 266:
    # 4*4096*266^2 - 4/3*266^3 = 1,159,266,304 - 25,094,570.67; B = Q^T A
    # 8,925,478,912; SVD of 266 x 4096: 6*4096*266^2 + 20*266^3 =
    # 1,738,899,456 + 376,418,560; U = Q U_B 2*4096*266^2 = 579,633,152.
    want = (8_925_478_912 + 1_159_266_304 - 25_094_570.666666668
            + 8_925_478_912 + 1_738_899_456 + 376_418_560 + 579_633_152)
    for cell in ("rsvd.fused", "rsvd.stored"):
        assert work.decomp_flops(*_cell(cell)) == pytest.approx(want)


def test_decomp_flops_hosvd():
    # three sketches 2*256*65536*32 = 1,073,741,824 each; three QRs of
    # 256 x 32: 4*256*32^2 - 4/3*32^3 = 1,048,576 - 43,690.67; the core:
    # 2*32*256*65536 + 2*32*256*8192 + 2*32*256*1024 =
    # 1,073,741,824 + 134,217,728 + 16,777,216.
    qr = 1_048_576 - 43_690.666666666664
    want = (3 * 1_073_741_824 + 3 * qr + 1_073_741_824 + 134_217_728
            + 16_777_216)
    assert work.decomp_flops(*_cell("hosvd.fused")) == pytest.approx(want)


def test_decomp_flops_sthosvd():
    # sketches on 256^3, 32 x 256 x 256, 32 x 32 x 256: 1,073,741,824 +
    # 134,217,728 + 16,777,216; the same three QRs and core products.
    qr = 1_048_576 - 43_690.666666666664
    want = (1_073_741_824 + 134_217_728 + 16_777_216 + 3 * qr
            + 1_073_741_824 + 134_217_728 + 16_777_216)
    assert work.decomp_flops(*_cell("hosvd.st")) == pytest.approx(want)


def test_mfu_reader():
    entry, config, traffic = _cell("rsvd.fused")
    ctx = {"entry": entry, "config": config, "traffic": traffic,
           "window": {"calls": 900, "seconds": 10.0}}
    flops = work.decomp_flops(entry, config, traffic)
    assert readers.load("mfu_pct")(ctx) == pytest.approx(
        100 * flops * 90 / 989e12)
