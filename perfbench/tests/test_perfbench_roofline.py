"""Work counted from the configuration file, against hand counts for
qwen3-4b."""
import pytest

from perfbench.core import roofline
from perfbench.core.bench import HERE, load_json

Q4B = load_json(HERE / "configs" / "qwen3-4b.json")
D, FF, HD, V, L = 2560, 9728, 128, 151936, 36


def test_param_counts():
    per_layer = D * 32 * HD * 2 + D * 8 * HD * 2 + 3 * D * FF + 2 * D
    total, active = roofline.param_counts(Q4B)
    assert total == active == L * per_layer + V * D == 4_022_456_320


def test_model_flops():
    assert roofline.model_flops(Q4B, "train", 8192) == 6.0 * 4_022_456_320 * 8192
    assert roofline.model_flops(Q4B, "forward", 10) == 2.0 * 4_022_456_320 * 10


def test_products_of_a_token():
    prods = roofline.dense_products(Q4B)
    weights = sum(k * n * calls for k, n, calls in prods)
    assert weights == L * (D * 4096 * 2 + D * 1024 * 2 + 3 * D * FF) + D * V == 4_022_272_000


def test_decode_tick_is_bandwidth_bound():
    # 64 rows: every product's bytes at 3.35 TB/s exceed its FLOPs at 989 TFLOP/s
    t = roofline.forward_products_time(Q4B, [(64, 64)])
    moved = sum(calls * 2 * (64 * k + k * n + 64 * n)
                for k, n, calls in roofline.dense_products(Q4B))
    assert t == pytest.approx(moved / 3.35e12)


def test_prefill_is_compute_bound():
    # a 4096-token prefill: the layers' products compute bound over 4096 rows; the
    # head runs on the last position alone, one row, so it reads its whole weight
    t = roofline.forward_products_time(Q4B, [(4096, 1)])
    layers = 2 * 4096 * L * (D * 4096 * 2 + D * 1024 * 2 + 3 * D * FF) / 989e12
    head = 2 * (D + D * V + V) / 3.35e12
    assert t == pytest.approx(layers + head)
    # the head over every row would count 2 * 4096 * D * V FLOPs that never ran
    every_row = roofline.forward_products_time(Q4B, [(4096, 4096)])
    assert every_row - t == pytest.approx(2 * 4096 * D * V / 989e12 - head)


def test_calls_add_up():
    calls = [(64, 64), (1000, 1), (64, 64)]
    assert roofline.forward_products_time(Q4B, calls) == pytest.approx(
        sum(roofline.forward_products_time(Q4B, [c]) for c in calls))


def test_product_kernels():
    assert roofline.is_product("void matmul_bf16_wgmma<128, 256>(...)")
    assert roofline.is_product("nvjet_hsh_256x128_64x4_2x1_v_bz_coopA_NNT")
    assert not roofline.is_product("void at::native::vectorized_elementwise_kernel<4>")
    assert not roofline.is_product("flash_attend_wgmma")


def test_train_products():
    rows = 8192
    one = roofline.least_time(rows, D, FF)
    assert one == pytest.approx(2 * rows * D * FF / 989e12)
    t = roofline.train_products_time(Q4B, rows, 1)
    # forward + recompute + dA + dB of the layers, forward + dA + dB of the head, all
    # compute bound at 8192 rows
    layers = 4 * 2 * rows * L * (D * 4096 * 2 + D * 1024 * 2 + 3 * D * FF)
    head = 3 * 2 * rows * D * V
    assert t == pytest.approx((layers + head) / 989e12, rel=1e-3)
