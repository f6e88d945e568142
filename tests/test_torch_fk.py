"""The FK kernels' launch geometry, and the FK kernels against their plain
versions on the card.

- `fused_step.fk_robots_per_block`, the FK launches' geometry (computed in
  the wrapper, passed to the C entry points, which launch ceil(B / robots)
  blocks): for go1's robot launch and the NPC launches of go1pushbox (box)
  and go1seesaw (seesaw), at their main-path B and at small and ragged B,
  the blocks cover every robot exactly once, a block's robots fit its 128
  threads, its shared memory stays within the 48 KB a block gets without
  opting in, go1 at B = 8192 keeps full blocks and an NPC launch of 4096
  spreads over at least two blocks on each of the H100's 132 SMs.
- The `cuda` cases hold `fk_spheres_kernel` and `fk_full_kernel` against
  `soa.fk_spheres` and `soa.fk_full` at the bound of
  tests/test_torch_soa.py::test_fk_matches_jax (1e-6), at the main path's B,
  at B = 1 and at a ragged B, for go1, box, seesaw and ball. They run only on
  a card: `python -m pytest --noconftest tests/test_torch_fk.py -m cuda`.
"""
import numpy as np
import pytest
import torch

from mqe_tpu_torch.physics import fused_step, soa
from mqe_tpu_torch.physics.model import load_model

torch.set_num_threads(1)

FK_TOL = 1e-6  # tests/test_torch_soa.py::test_fk_matches_jax
# (model, root_free) as the scene loads them: go1's robots, the box and the
# welded seesaw of the NPC tasks, the ball
MODELS = {"go1": True, "box": True, "seesaw": False, "ball": True}
GEOMETRY_CASES = ([("go1", B) for B in (1, 37, 8192)]
                  + [(n, B) for n in ("box", "seesaw") for B in (1, 37, 4095, 4096)])


def _geometry(name, B):
    """(model, robots a block, blocks, shared bytes a block) of an FK launch."""
    m = load_model(name, root_free=MODELS[name])
    ns = len(m.sph_tags)
    R = fused_step.fk_robots_per_block(fused_step.lanes_log2(m), ns, B)
    return m, R, -(-B // R), fused_step.fk_shared_bytes(R, ns)


@pytest.mark.parametrize("name,B", GEOMETRY_CASES)
def test_fk_geometry_covers_every_robot_once(name, B):
    m, R, blocks, shared = _geometry(name, B)
    assert R >= 1 and (R << fused_step.lanes_log2(m)) <= fused_step.THREADS
    covered = np.concatenate([np.arange(b * R, min(B, (b + 1) * R)) for b in range(blocks)])
    np.testing.assert_array_equal(covered, np.arange(B))
    assert shared <= 48 * 1024


def test_fk_geometry_fills_the_card_at_the_main_path_shapes():
    """go1's 8192 robots in full blocks (8 robots of 16 lanes); the NPC
    launches of 4096 in at least 264 blocks, where one robot a lane would
    give 32 (box) and 64 (seesaw)."""
    assert _geometry("go1", 8192)[1:3] == (8, 1024)
    for name in ("box", "seesaw"):
        blocks = _geometry(name, 4096)[2]
        assert blocks >= 2 * 132, (name, blocks)


def test_fk_geometry_keeps_shared_memory_within_the_limit_for_every_sphere_count():
    """Many spheres a robot cut the robots a block, never below one."""
    limit = fused_step.SHARED_LIMIT
    for ll in range(5):
        for ns in (0, 1, 8, 35, 40, 64):
            R = fused_step.fk_robots_per_block(ll, ns, 1 << 20)
            assert 1 <= R <= fused_step.THREADS >> ll
            assert fused_step.fk_shared_bytes(R, ns) <= limit
            if R < fused_step.THREADS >> ll:
                assert fused_step.fk_shared_bytes(R + 1, ns) > limit


def _fk_args(m, B, seed=5):
    """Inputs drawn as tests/test_torch_soa.py::test_fk_matches_jax draws them."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, 3) * 0.1, rng.randn(B, 4) * 0.05 + np.array([0, 0, 0, 1.0]),
            rng.randn(B, 3) * 0.3, rng.randn(B, 3) * 0.3, rng.randn(B, m.nq) * 0.2,
            rng.randn(B, m.nq) * 0.5]
    arrs[1] /= np.linalg.norm(arrs[1], axis=1, keepdims=True)
    return [torch.as_tensor(a.astype(np.float32), device="cuda") for a in arrs]


# (kernel, model): the B values of each, the main path's first
CARD_CASES = {
    ("fk_spheres", "go1"): (8192, 37, 1),
    ("fk_spheres", "box"): (37, 1),
    ("fk_spheres", "seesaw"): (37, 1),
    ("fk_spheres", "ball"): (37, 1),
    ("fk_full", "box"): (4096, 4095, 37, 1),
    ("fk_full", "seesaw"): (4096, 4095, 37, 1),
    ("fk_full", "ball"): (37, 1),
    ("fk_full", "go1"): (37, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,name", list(CARD_CASES))
def test_fk_kernels_match_plain_on_card(kernel, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    m = load_model(name, root_free=MODELS[name])
    wrapper = getattr(fused_step, f"{kernel}_kernel")
    plain = getattr(soa, kernel)
    for B in CARD_CASES[(kernel, name)]:
        args = _fk_args(m, B)
        ref = plain(m, *args)
        before = wrapper.launches
        out = wrapper(m, *args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        for i, (a, b) in enumerate(zip(ref, out)):
            assert a.shape == b.shape, (B, i)
            diff = float((a - b).abs().max()) if a.numel() else 0.0
            assert diff <= FK_TOL, f"B={B} output {i}: max diff {diff:.3e} > {FK_TOL:.0e}"
