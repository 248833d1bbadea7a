"""The counted work, the idle share and the readers' arithmetic against
brute force on small synthetic inputs."""

import math
import random
from types import SimpleNamespace

import pytest
import torch

from harness import spec, trace as T, work as W
from reference.models import pwcnet as ref_pwcnet


def _kernels(rng, n):
    ks = []
    for _ in range(n):
        s = rng.randrange(0, 1000)
        ks.append(T.Kernel("k%d" % rng.randrange(3), s, s + rng.randrange(1, 60)))
    return sorted(ks, key=lambda k: k.start_us)


@pytest.mark.parametrize("seed", range(5))
def test_busy_and_idle_against_a_grid(seed):
    rng = random.Random(seed)
    ks = _kernels(rng, 40)
    grid = [any(k.start_us <= t < k.end_us for k in ks) for t in range(1100)]
    assert T.busy_us(ks) == sum(grid)
    tr = T.Trace(ks, wall_s=1100e-6, steps=2)
    read = spec.metric_reader("device_idle")
    idle = read(SimpleNamespace(trace=tr))
    assert idle == pytest.approx(100.0 * (1 - sum(grid) / 1100))
    assert spec.metric_reader("launches_per_step")(
        SimpleNamespace(trace=tr)) == 20.0


def test_idle_gaps_are_labelled_by_the_innermost_host_op():
    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = lambda name, a, b, d=cpu, i=0: SimpleNamespace(
        name=name, device_type=d, id=i,
        time_range=SimpleNamespace(start=a, end=b))
    events = [ev("step", 0, 100), ev("aten::mul", 10, 30), ev("aten::add", 60, 90)]
    ks = [T.Kernel("a", 0, 15), T.Kernel("b", 25, 65), T.Kernel("c", 80, 100)]
    # gaps: 15-25 (mid 20, in aten::mul), 65-80 (mid 72.5, in aten::add)
    gaps = T.idle_gaps(ks, events)
    assert [g[0] for g in gaps] == ["aten::add", "aten::mul"]
    assert [g[1] for g in gaps] == pytest.approx([15e-6, 10e-6])
    # kernels launched inside the span: ids tie them to their launches
    events += [ev("bench.flow_fn", 5, 40), ev("cudaLaunchKernel", 12, 13, i=7),
               ev("cudaLaunchKernel", 50, 51, i=8), ev("a", 20, 26, dev, 7),
               ev("b", 60, 70, dev, 8), ev("cudaLaunchKernel", 14, 15, i=9),
               ev("c", 22, 30, dev, 9)]
    # the union of the kernels launched inside: 20-26 and 22-30
    assert T.span_kernel_us(events, "bench.flow_fn") == 10


@pytest.mark.parametrize("seed", range(4))
def test_box_pairs_against_every_pixel(seed):
    g = torch.Generator().manual_seed(seed)
    Tt, S, cap, tiles_x = 3, 2, 8, 2
    mx = torch.rand((Tt, S, cap), generator=g) * 40 - 4
    my = torch.rand((Tt, S, cap), generator=g) * 40 - 4
    r = torch.rand((Tt, S, cap), generator=g) * 10
    tile_ids = torch.tensor([0, 1, 3], dtype=torch.int32)
    slots = torch.randint(0, cap + 1, (Tt, S), generator=g)
    want = 0
    for t in range(Tt):
        tx, ty = int(tile_ids[t]) % tiles_x, int(tile_ids[t]) // tiles_x
        for s in range(S):
            for j in range(int(slots[t, s])):
                for py in range(16):
                    for px in range(16):
                        x, y = tx * 16 + px + 0.5, ty * 16 + py + 0.5
                        want += (abs(x - mx[t, s, j]) <= r[t, s, j]
                                 and abs(y - my[t, s, j]) <= r[t, s, j])
    assert W.box_pairs(mx, my, r, tile_ids, tiles_x, slots) == int(want)


def test_call_work_counts_and_bounds():
    Tt, S, Fd, cap, nchan = 2, 3, 7, 4, 5
    dyn = torch.zeros((Tt, S, Fd, cap))
    dyn[:, :, 0] = 8.0  # mx, my at a tile's centre, r = 2: 4 x 4 pixels
    dyn[:, :, 1] = 8.0
    dyn[:, :, 5] = 2.0
    slots = torch.tensor([[4, 2, 0], [1, 1, 1]])
    work = {"slots": slots, "live": 30, "pairs": 0}
    c = W.call_work("window", dyn, torch.tensor([0, 0], dtype=torch.int32),
                    1, nchan, (Fd, 2), work, out_floats=100)
    walked = int(slots.sum())
    boxed = walked * 16
    tests = W.OPS_BOX * walked * W.NWARPS
    assert c.ops["fwd"] == W.OPS_PAIR * boxed + tests + (2 * nchan + 3) * 30
    assert c.ops["bwd"] == W.OPS_PAIR * boxed + tests + (4 * nchan + 36) * 30
    payload = 4 * (walked * Fd + (4 + 1) * 2)  # per-row payload to the furthest s
    assert c.bytes["fwd"] == payload + 400
    assert c.bytes["bwd"] == 2 * payload + 800
    sw = W.StepWork([c, c], other_ops=1e6)
    bw, peak = 1e9, 1e12
    least = 2 * (max(c.bytes["fwd"] / bw, c.ops["fwd"] / peak)
                 + max(c.bytes["bwd"] / bw, c.ops["bwd"] / peak))
    assert sw.composite_least_s(bw, peak) == pytest.approx(least)
    ks = [T.Kernel("void window_fwd_kernel<5>(...)", 0, 300),
          T.Kernel("void window_bwd_kernel<5>(...)", 300, 900),
          T.Kernel("elementwise", 900, 2000)]
    ctx = SimpleNamespace(trace=T.Trace(ks, wall_s=4e-3, steps=2),
                          work=[sw, sw], bandwidth=bw, peak_flops=peak)
    roof = spec.metric_reader("composite_roofline")(ctx)
    assert roof == pytest.approx(100 * least / (900e-6 / 2))
    mfu = spec.metric_reader("step_mfu")(ctx)
    assert mfu == pytest.approx(100 * sw.total_ops() / (2e-3 * peak))
    empty = SimpleNamespace(trace=T.Trace([], 1.0, 1), work=[], bandwidth=bw,
                            peak_flops=peak, )
    for name in ("composite_roofline", "step_mfu", "device_idle",
                 "launches_per_step", "flow_ms"):
        empty.trace.span_us = {}
        assert spec.metric_reader(name)(empty) is None


def test_pwcnet_ops_against_the_reference_nets_layers():
    cfg = spec.load_cell("low.stage2").config
    pw = cfg["pwcnet"]
    H, W_ = 72, 100
    net = ref_pwcnet.PWCNet().eval()
    convs = []

    def hook(m, inp, out):
        if isinstance(m, torch.nn.ConvTranspose2d):
            n = inp[0].shape[-2] * inp[0].shape[-1]
        else:
            n = out.shape[-2] * out.shape[-1]
        convs.append(2.0 * m.kernel_size[0] * m.kernel_size[1]
                     * m.in_channels * m.out_channels * n * out.shape[0])

    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    a = torch.rand((1, H, W_, 3))
    with torch.no_grad():
        ref_pwcnet.pwcnet_flow(net, a, a)
    Hp, Wp = 128, 128
    other = 0.0
    for level in pw["levels"]:
        C = pw["extractor"][level - 1][1]
        n = (Hp >> level) * (Wp >> level)
        other += 2.0 * 81 * C * n + (8.0 * (C + 1) * n if level < 6 else 0)
    assert W.pwcnet_ops(pw, H, W_, 1) == pytest.approx(sum(convs) + other)


def test_the_configurations_state_the_reference_nets_widths():
    net = ref_pwcnet.PWCNet()
    for name in ("stereo_high", "stereo_low"):
        pw = spec.load_cell(name.replace("stereo_", "") + ".stage2").config["pwcnet"]
        ext = [[m[0].in_channels, m[0].out_channels] for m in
               (getattr(net.netExtractor, n) for n in net.netExtractor.names)]
        assert ext == pw["extractor"]
        dec = net.netTwo
        outs = [getattr(dec, n)[0].out_channels
                for n in ("netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix")]
        assert outs == pw["decoder_convs"]
        ref = [[m.in_channels, m.out_channels, m.dilation[0]]
               for m in net.netRefiner.netMain if isinstance(m, torch.nn.Conv2d)]
        assert ref == pw["refiner"]
        assert math.isclose(W.flow_ops({**spec.load_cell("low.stage2").config,
                                        "pwcnet": pw},
                                       {"flow_term": False}), 0.0)
