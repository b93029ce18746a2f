"""The fused Adam kernel (ops/csrc/adam.cu) on the card against the plain
version, ``model/optim.py:_adam_``.

Needs an NVIDIA GPU with nvcc: marked ``cuda`` and skipped elsewhere. On
the card, run without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_adam_cuda.py -q

The two run on clones of the same CUDA tensors, and every case requires
the parameters, both moments and the step counter to be equal bit for bit:
the kernel repeats PyTorch's op order and roundings. The sizes are ragged
(1,000,003 Gaussians: element counts that are not a multiple of 4), the
gradients of features_dc and features_rest come both contiguous and as
the slices of one [N, 16, 3] gradient that autograd hands them.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

N_RAGGED = 1_000_003


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _gaussian_state(n, f, dev, seed, cat_grads, step=0):
    """Random fields, gradients and moments of n Gaussians with f semantic
    channels; second moments non-negative."""
    from feature3dgs_tpu_torch.model import optim
    from feature3dgs_tpu_torch.model.gaussians import GaussianParams
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"xyz": (n, 3), "features_dc": (n, 1, 3),
              "features_rest": (n, 15, 3), "scaling": (n, 3),
              "rotation": (n, 4), "opacity": (n, 1),
              "semantic_feature": (n, 1, f)}

    def draw(scale, square=False):
        out = {}
        for k, s in shapes.items():
            x = torch.randn(s, generator=gen, device=dev) * scale
            out[k] = x * x if square else x
        return out

    grads = draw(1e-3)
    if cat_grads:
        g = torch.randn((n, 16, 3), generator=gen, device=dev) * 1e-3
        grads["features_dc"], grads["features_rest"] = g[:, :1], g[:, 1:]
    adam = optim.AdamState(GaussianParams(**draw(1e-3)),
                           GaussianParams(**draw(1e-3, square=True)),
                           torch.tensor(step, dtype=torch.int32, device=dev))
    return GaussianParams(**draw(1.0)), GaussianParams(**grads), adam


def _clone(params, adam):
    from feature3dgs_tpu_torch.model import optim
    from feature3dgs_tpu_torch.model.gaussians import GaussianParams

    def copy(p):
        return GaussianParams(**{k: getattr(p, k).clone()
                                 for k in GaussianParams.FIELDS})
    return copy(params), optim.AdamState(copy(adam.mu), copy(adam.nu),
                                         adam.step.clone())


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_bit_equal(got, want):
    from feature3dgs_tpu_torch.model.gaussians import GaussianParams
    (gp, ga), (wp, wa) = got, want
    for k in GaussianParams.FIELDS:
        for part, a, b in (("p", gp, wp), ("mu", ga.mu, wa.mu),
                           ("nu", ga.nu, wa.nu)):
            assert torch.equal(_bits(getattr(a, k)), _bits(getattr(b, k))), \
                (part, k)
    assert torch.equal(ga.step, wa.step)


def _plain(params, grads, adam, lrs, keep):
    from feature3dgs_tpu_torch.model import optim
    fields = optim._fields
    with torch.no_grad():
        optim._adam_(fields(params), fields(grads), fields(adam.mu),
                     fields(adam.nu), adam.step, lrs, 0.9, 0.999, 1e-15, keep)


LRS = {"xyz": 1.6e-4, "features_dc": 0.0025, "features_rest": 0.0025 / 20,
       "scaling": 0.005, "rotation": 0.001, "opacity": 0.05,
       "semantic_feature": 0.001}


@pytest.mark.parametrize("f_dim,start", [(128, 0), (512, 14_999)])
@pytest.mark.parametrize("keep", [None, True, False])
@pytest.mark.parametrize("cat_grads", [False, True])
def test_fused_adam_bit_equal_to_plain(dev, f_dim, start, keep, cat_grads):
    """Seven fields at 1,000,003 Gaussians, two successive steps; with keep
    False every byte and the counter stay as they were."""
    from feature3dgs_tpu_torch.model import optim
    from feature3dgs_tpu_torch.ops import cuda_adam
    params, grads, adam = _gaussian_state(N_RAGGED, f_dim, dev, f_dim,
                                          cat_grads, start)
    ref = _clone(params, adam)
    before = _clone(params, adam)
    gate = None if keep is None else torch.tensor(keep, device=dev)
    for _ in range(2):
        launches = cuda_adam.ADAM_LAUNCHES
        optim.adam_update(params, grads, adam, LRS, keep=gate)
        assert cuda_adam.ADAM_LAUNCHES == launches + 1
        _plain(ref[0], grads, ref[1], LRS, gate)
        torch.cuda.synchronize()
        _assert_bit_equal((params, adam), ref)
    if keep is False:
        _assert_bit_equal((params, adam), before)
    else:
        assert int(adam.step) == start + 2
        assert not torch.equal(params.xyz, before[0].xyz)


@pytest.mark.parametrize("keep", [None, True, False])
def test_fused_decoder_adam_bit_equal_to_plain(dev, keep):
    """The decoder's group: w 128 x 512 and b 512, eps 1e-8, its own
    counter, one launch."""
    from feature3dgs_tpu_torch.model import optim
    from feature3dgs_tpu_torch.ops import cuda_adam
    gen = torch.Generator(device=dev).manual_seed(5)

    def group(scale, square=False):
        out = {k: torch.randn(s, generator=gen, device=dev) * scale
               for k, s in (("w", (128, 512)), ("b", (512,)))}
        return {k: v * v for k, v in out.items()} if square else out

    params, grads = group(0.1), group(1e-3)
    state = optim.TensorAdamState(group(1e-3), group(1e-3, square=True),
                                  torch.tensor(7, dtype=torch.int32,
                                               device=dev))
    ref = ({k: v.clone() for k, v in params.items()},
           {k: v.clone() for k, v in state.mu.items()},
           {k: v.clone() for k, v in state.nu.items()}, state.step.clone())
    gate = None if keep is None else torch.tensor(keep, device=dev)
    for _ in range(2):
        launches = cuda_adam.ADAM_LAUNCHES
        optim.tensor_adam_update(params, grads, state, lr=1e-4, keep=gate)
        assert cuda_adam.ADAM_LAUNCHES == launches + 1
        with torch.no_grad():
            optim._adam_(ref[0], grads, ref[1], ref[2], ref[3],
                         dict.fromkeys(params, 1e-4), 0.9, 0.999, 1e-8, gate)
        torch.cuda.synchronize()
        for got, want in ((params, ref[0]), (state.mu, ref[1]),
                          (state.nu, ref[2])):
            for k in got:
                assert torch.equal(_bits(got[k]), _bits(want[k])), k
        assert torch.equal(state.step, ref[3])
    assert int(state.step) == (7 if keep is False else 9)


def test_bias_corrections_bit_equal_over_a_run(dev):
    """The kernel's c1 = 1 - 0.9^t and c2 = 1 - 0.999^t are torch.pow's at
    every 13th step of a 30,000-step run and at its first 64: the update of
    random moments, which divides by both, is bit-equal at each."""
    from feature3dgs_tpu_torch.model import optim
    gen = torch.Generator(device=dev).manual_seed(11)
    g = {"x": torch.randn(1027, generator=gen, device=dev)}
    base = {k: torch.randn(1027, generator=gen, device=dev)
            for k in ("p", "m")}
    base["v"] = torch.rand(1027, generator=gen, device=dev)
    steps = sorted(set(range(64)) | set(range(0, 30_000, 13)))
    for s in steps:
        got = {k: {"x": v.clone()} for k, v in base.items()}
        want = {k: {"x": v.clone()} for k, v in base.items()}
        sg = torch.tensor(s, dtype=torch.int32, device=dev)
        sw = sg.clone()
        with torch.no_grad():
            optim._adam_by_device(got["p"], g, got["m"], got["v"], sg,
                                  {"x": 1e-3}, 0.9, 0.999, 1e-15, None)
            optim._adam_(want["p"], g, want["m"], want["v"], sw,
                         {"x": 1e-3}, 0.9, 0.999, 1e-15, None)
        for k in got:
            assert torch.equal(_bits(got[k]["x"]), _bits(want[k]["x"])), (s, k)
        assert torch.equal(sg, sw)


def test_fused_adam_after_densification_replaced_the_tensors(dev):
    """A clone / split / prune round rebinds every field to a new tensor
    (and zeroes the moments of the rows it wrote); the next fused step
    updates those, bit-equal to the plain one on a copy of the densified
    state."""
    from feature3dgs_tpu_torch.model import density, optim
    from feature3dgs_tpu_torch.model.gaussians import GaussianState
    n, cap = 20_003, 30_011
    params, grads, adam = _gaussian_state(cap, 16, dev, 3, True)
    gen = torch.Generator(device=dev).manual_seed(4)
    alive = torch.arange(cap, device=dev) < n
    state = GaussianState.fresh(alive)
    state.xyz_gradient_accum = torch.rand(cap, generator=gen, device=dev)
    state.denom = torch.ones(cap, device=dev)
    params.scaling.copy_(torch.rand((cap, 3), generator=gen, device=dev)
                         * 3 - 6)
    params.opacity.fill_(1.0)
    noise = torch.randn((2, cap, 3), generator=gen, device=dev)
    ref = _clone(params, adam)
    optim.adam_update(params, grads, adam, LRS)
    _plain(ref[0], grads, ref[1], LRS, None)
    _assert_bit_equal((params, adam), ref)

    old = [params.xyz.data_ptr(), adam.mu.xyz.data_ptr()]
    density.densify_and_prune(params, state, adam, noise, max_grad=0.5,
                              min_opacity=0.005, extent=4.0,
                              percent_dense=0.01,
                              use_screen_size_prune=False)
    assert int(state.alive.sum()) > n
    assert params.xyz.data_ptr() not in old
    ref = _clone(params, adam)
    optim.adam_update(params, grads, adam, LRS)
    _plain(ref[0], grads, ref[1], LRS, None)
    torch.cuda.synchronize()
    _assert_bit_equal((params, adam), ref)


def test_one_launch_a_group_and_no_allocation(dev):
    """Under the profiler a group's update is the kernel and the counter's
    add, nothing else; and the call allocates nothing on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from feature3dgs_tpu_torch import tracing
    from feature3dgs_tpu_torch.model import optim
    params, grads, adam = _gaussian_state(N_RAGGED, 128, dev, 2, True)
    keep = torch.tensor(True, device=dev)
    optim.adam_update(params, grads, adam, LRS, keep=keep)    # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        optim.adam_update(params, grads, adam, LRS, keep=keep)
        torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) == before
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    assert sum("adam_kernel" in k for k in kernels) == 1, kernels
    assert len(kernels) == 2, kernels
    counters = tracing.last_session().summary()["counters"]
    assert counters.get("optim.adam_fused") == 7
    assert "optim.adam_plain" not in counters


def test_trainer_steps_take_the_fused_path(dev):
    """A speed-up training step on the card updates 7 fields and the
    decoder's 2 tensors in two launches; nothing takes the plain path."""
    from feature3dgs_tpu_torch import tracing
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.ops import cuda_adam
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import Trainer
    tr = Trainer(synthetic_scene(n_cams=3, w=64, h=48, n_pts=200, f_dim=8),
                 rcfg=RasterConfig(tile_w=16, tile_h=16, chunk=16,
                                   instance_capacity=1 << 13),
                 speedup=True, device="cuda")
    tr.step(sync=True)
    launches = cuda_adam.ADAM_LAUNCHES
    with tracing.recording() as session:
        for sync in (False, True):
            tr.step(sync=sync)
    counters = session.summary()["counters"]
    assert counters.get("optim.adam_fused") == 2 * 9
    assert "optim.adam_plain" not in counters
    assert cuda_adam.ADAM_LAUNCHES == launches + 4
    assert int(tr.ts.adam.step) == 3 and int(tr.ts.decoder_adam.step) == 3
    for k in tr.ts.params.FIELDS:
        assert torch.isfinite(getattr(tr.ts.params, k)).all(), k


@pytest.mark.parametrize("fault", ["p_transposed", "p_float64", "grad_cpu",
                                   "step_cpu", "keep_cpu", "too_many"])
def test_wrapper_refuses_what_the_kernel_does_not_take(dev, fault):
    from feature3dgs_tpu_torch.model import optim
    from feature3dgs_tpu_torch.ops import cuda_adam
    make = lambda: {"a": torch.zeros(6, 4, device=dev)}  # noqa: E731
    params, grads, mu, nu = make(), make(), make(), make()
    step = torch.zeros((), dtype=torch.int32, device=dev)
    keep = torch.tensor(True, device=dev)
    lrs = {"a": 1e-3}
    if fault == "p_transposed":
        params["a"] = torch.zeros(4, 6, device=dev).t()
    elif fault == "p_float64":
        params["a"] = params["a"].double()
    elif fault == "grad_cpu":
        grads["a"] = grads["a"].cpu()
    elif fault == "step_cpu":
        step = step.cpu()
    elif fault == "keep_cpu":
        keep = keep.cpu()
    else:
        params, grads, mu, nu = ({f"t{i}": torch.zeros(4, device=dev)
                                  for i in range(cuda_adam.MAX_TENSORS + 1)}
                                 for _ in range(4))
        lrs = dict.fromkeys(params, 1e-3)
    launches = cuda_adam.ADAM_LAUNCHES
    with pytest.raises(ValueError):
        with torch.no_grad():
            optim._adam_by_device(params, grads, mu, nu, step, lrs, 0.9,
                                  0.999, 1e-15, keep)
    assert cuda_adam.ADAM_LAUNCHES == launches


def test_kernel_keeps_its_loads_in_registers(dev):
    """The design's residency: no spills to local memory, and at least two
    blocks of 256 threads an SM, so that each SM has 2 x 256 x 4 float4
    loads of each array in flight to cover HBM's latency."""
    from feature3dgs_tpu_torch.ops import cuda_adam
    attrs = cuda_adam.kernel_attributes()
    print("adam kernel", attrs)
    assert attrs["local_bytes"] == 0, attrs
    assert attrs["blocks_per_sm"] >= 2, attrs
