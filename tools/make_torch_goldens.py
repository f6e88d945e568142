"""Record the JAX side of the port's step tests (tests/test_torch_env.py,
tests/test_torch_tasks.py, tests/test_torch_npc.py, and the others named
below): control steps and NPC substeps of the JAX package, which the port's
CPU tests replay without running JAX.

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py [FILE ...]

With no FILE it writes each file of FILES that is not on disk yet; a FILE
named (e.g. torch_go1pushbox_step.npz) is written again. Each file holds
cases of one task at num_envs=2. The env is reset with PRNGKey(0) and stepped
WARM_STEPS times under actions drawn uniform(-1, 1) from RandomState(3), with
step keys split from PRNGKey(1). The cases start from:
  - "post-reset": the reset state;
  - "in-contact": the state after WARM_STEPS steps (feet on the ground);
  - "reset-step": the in-contact state with episode_length set to
    max_episode_length - 1, so that the step times out in every env and
    takes the masked reset. Its record also holds "fresh", the reset state
    the JAX step drew (`_reset_all` of the third of
    jax.random.split(PRNGKey(7), 4)), which the port takes through `Draws`.
  - "selfplay": the in-contact state, stepped by a second wrapper of the
    same env with `selfplay = True` (the competitive tasks' per-seat reward).
From each start, one step with that start's actions and PRNGKey(7) is
recorded: the start state, the actions, and the step's state, observations,
reward and done. Each pytree is flattened to "<case>/<record>/<path>" keys.
The actions are those of the robots the wrapper controls
(`controlled_agents`, 2 of football-defender's 3). For the sheep tasks each
case also holds "<case>/npc_noise", the step's normal draw of the sheep
script (`jax.random.normal` of the first of jax.random.split(PRNGKey(7), 4),
(E, N, 3)), which the port takes through `Draws` under that name.

torch_npc_substep.npz holds one `scene.substep_batch` with NPCs at 2 envs
(op by op, no jit) for each case of `NPC_CASES`, from hand-placed states:
the go1pushbox scene (robots pressed against the box, the box on the
ground), the go1seesaw scene (a robot on the plank, one against the pivot
cylinder, one on the platform) and two balls on the pushbox terrain (NPC-NPC
pairs). States, domain randomisation and torques are drawn from
RandomState(2). Each case records "<case>/task" and "<case>/npc" (the NPC
model put in the task's place, or ""), "<case>/dt", the inputs
"<case>/{agents,npcs}/<field>", "<case>/dr/{mu,payload,com}", "<case>/tau",
"<case>/npc_tau", and JAX's "<case>/out/{agents,npcs}/<field>" and
"<case>/contact/{sphere_force,npc_sphere_force,feet_force}".

torch_static_substep.npz holds the same record for `STATIC_CASES`: robots
standing on and against the go1wrestling ring (a static cylinder), on the
go1bridge deck and against its side (static boxes), and four go1football-2vs2
robots, one with its head in the ball (the ball's sphere primitive). The
static tasks' scenes have no colliding NPC: their NPC is the welded anchor,
which the substep passes through.

torch_learn.npz holds the training stack's pieces on fixed inputs
(tests/test_torch_learn.py), all op by op without jit:
  - "nets/<net>/...": flax `ActorCritic`, `RecurrentActorCritic` and
    `MATNetwork` at narrow widths (`NARROW`), initialised from PRNGKey(0):
    their params ("nets/<net>/params/..."), inputs drawn from
    RandomState(4) and outputs (the GRU over three steps of carry,
    "out/<step>/...");
  - "ckpt/<task>/...": the full-width policy of each of `CHECKPOINTS`, its
    params read from the JAX package's TrainState `.npz` (the first leaves,
    in tree order), applied to drawn observations (and a drawn GRU state);
  - "logp/...", "gae/...": `gaussian_logp`, and `PPOTrainer._valuenorm`,
    `_gae` (dones mid-trajectory), `_valuenorm_update` and the advantage
    normalisation on drawn arrays;
  - "loss/<algo>/...": `_loss` and every gradient leaf
    (`jax.value_and_grad`) of ppo, dppo and MAT on a drawn batch whose
    ratios lie on both sides of the clip and, in two rows, past the dual
    clip;
  - "optim/...": three steps of the trainers' optax chain
    (`clip_by_global_norm(0.5)`, `adam(7e-4, eps=1e-5)`) from drawn
    gradients, the second above the clip norm;
  - "terms/<task>": each registered task's reward-term names as
    `PPOTrainer._discover_term_names` finds them (`jax.eval_shape`).

torch_go1gate_ppo_update.npz holds one `PPOTrainer` update of go1gate at
num_envs=2 (`UPDATE_CFG`: rollout_len 4, num_minibatches 4, ppo_epochs 4),
its network at `NARROW` widths (the record stays small), started from the
"in-contact" start state of torch_go1gate_step.npz (read from that file)
with seed-0 init params ("init/params/..."):
the action noise of each rollout step ("noise", the `k_act` draws), the
rollout ("traj/...", "final_value", the end state "out_env/..." and the
episode sums "ep_acc/..."; one jit of `_rollout`), the permutation of each
epoch ("perm"), and the params, return statistics and metrics after the
update ("after/..."; `_update_impl` jitted with `_rollout` returning the
recorded rollout). "mat/..." holds the same for a `MATTrainer` (seed-0
init params, its permutations, params after) learning from that rollout.

The locomotion slice (tests/test_torch_loco_env.py, test_torch_policy.py):
  - torch_locomotion_step.npz: LocomotionEnv at 4 envs (`record_locomotion`,
    the cases of `LOCO_CASES`): its reset with the draws it made, and one
    step with its draws by the names the port takes them under
    ("cmd_vx", "cmd_vy", "cmd_wz", "cmd_switch", "gait_switch",
    "gait_other") and its fresh state;
  - torch_locomotion_ppo_update.npz: one PPOTrainer update of LocomotionEnv
    at 2 envs with each step's action noise and command draws
    (`record_loco_ppo_update`);
  - torch_policy_step.npz: go1plane with the `policy` backend
    (`record_policy_backend`); for the walk-these-ways stack
    `mqe_tpu.ASSETS_DIR` points, inside this process only, at a temporary
    copy of the assets without body_policy.npz (`_AssetsWithout`);
  - torch_go1gate_events_step.npz: go1gate with push, action lag and
    tanh/delta command clipping, and a step where each termination term
    fires (`record_events`).

The terrain, camera and MPC slice (tests/test_torch_terrain.py,
test_torch_camera.py, test_torch_mpc.py): torch_terrain.npz
(`record_terrain`: the Legacy and Perlin builds, the curriculum's steps, a
heightfield step, a step on two rows of go1gate's track), torch_camera.npz
(`record_camera`: depth and RGB images from recorded states) and
torch_mpc.npz (`record_mpc`: the iLQR's passes, whole solves with the step
sizes chosen, and the costs at their hinges' kinks).

The trajectory goldens (tests/test_torch_golden_traj.py,
test_torch_golden_steps.py): torch_golden_traj.npz (`record_golden_traj`:
their starts and draws) and torch_golden_steps.npz (`record_golden_steps`:
their scan state by state, and JAX's own spread about each step).
Nothing under mqe_tpu/ is written.
"""
import os
import sys
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "goldens")
NUM_ENVS = 2
WARM_STEPS = 25
STARTS = {"post-reset": 0, "in-contact": WARM_STEPS, "reset-step": WARM_STEPS,
          "selfplay": WARM_STEPS}
ACTOR_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "q", "qd")


def _flat(prefix, tree):
    """{prefix/path: numpy array} of a pytree (dataclass fields and dict keys)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(k, "name", getattr(k, "key", k))) for k in path]
        out["/".join([prefix] + names)] = np.asarray(leaf)
    return out


def record(task="go1gate", cases=("post-reset", "in-contact")) -> dict:
    """The record of `cases` of `task` as a dict of numpy arrays."""
    import jax.numpy as jnp

    from mqe_tpu.envs.registry import make_mqe_env

    wrap, _ = make_mqe_env(task, num_envs=NUM_ENVS, seed=0)
    ts, _ = wrap.reset(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    nact = getattr(wrap, "controlled_agents", wrap.num_agents)
    acts = rng.uniform(-1, 1, (WARM_STEPS + 1, NUM_ENVS, nact, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    states = [ts]
    for t in range(WARM_STEPS):
        key, k = jax.random.split(key)
        ts = wrap.step(ts, acts[t], k)[0]
        states.append(ts)
    rec = {}
    for case in cases:
        start = STARTS[case]
        ts0 = states[start]
        if case == "reset-step":
            last = wrap.env.max_episode_length - 1
            ts0 = ts0.replace(env=ts0.env.replace(
                episode_length=jnp.full((NUM_ENVS,), last, dtype=jnp.int32)))
            k_reset = jax.random.split(jax.random.PRNGKey(7), 4)[2]
            rec.update(_flat(f"{case}/fresh", wrap.env._reset_all(k_reset)))
        stepper = wrap
        if case == "selfplay":
            stepper = type(wrap)(wrap.env)  # the flag is read when the step is traced
            stepper.selfplay = True
        if wrap.env.npc_behavior == "sheep":
            k_npc = jax.random.split(jax.random.PRNGKey(7), 4)[0]
            rec[f"{case}/npc_noise"] = np.asarray(
                jax.random.normal(k_npc, (NUM_ENVS, wrap.num_npcs, 3)))
        ts1, obs, rew, done, _ = stepper.step(ts0, acts[start], jax.random.PRNGKey(7))
        rec.update(_flat(f"{case}/start", ts0))
        rec.update(_flat(f"{case}/out", ts1))
        rec[f"{case}/actions"] = acts[start]
        rec[f"{case}/obs"] = np.asarray(obs)
        rec[f"{case}/reward"] = np.asarray(rew)
        rec[f"{case}/done"] = np.asarray(done)
    return rec


# ---------------------------------------------------------------------------
# one NPC substep from hand-placed states (torch_npc_substep.npz)
# ---------------------------------------------------------------------------

def _agents(env, rng):
    """Robot state (E, A, ...) standing at the agent origins, small noise."""
    E, A = NUM_ENVS, env.num_agents
    pos = np.zeros((E, A, 3), np.float32)
    pos[..., :2] = np.asarray(env.agent_origins)[..., :2]
    pos[..., 2] = 0.30 + rng.randn(E, A) * 0.01
    qt = rng.randn(E, A, 4) * 0.03 + np.array([0, 0, 0, 1.0])
    return dict(pos=pos, quat=qt / np.linalg.norm(qt, axis=-1, keepdims=True),
                lin_vel=rng.randn(E, A, 3) * 0.3, ang_vel=rng.randn(E, A, 3) * 0.3,
                q=np.asarray(env.default_q) + rng.randn(E, A, 12) * 0.1,
                qd=rng.randn(E, A, 12) * 0.5)


def _npcs(pos, qs, qds, rng):
    E, N = NUM_ENVS, pos.shape[1]
    return dict(pos=pos, quat=np.tile([0, 0, 0, 1.0], (E, N, 1)),
                lin_vel=rng.randn(E, N, 3) * 0.05, ang_vel=rng.randn(E, N, 3) * 0.05,
                q=qs, qd=qds)


def _pushbox_state(env, rng):
    ag = _agents(env, rng)
    eo = np.asarray(env.env_origins)
    box = eo + np.array([2.5, 0.0, 0.49])                  # 1 cm into the ground
    ag["pos"][0, 0] = box[0] + np.array([-0.76, 0.0, -0.19])  # head into the -x face
    ag["pos"][1, 0] = box[1] + np.array([0.0, -0.53, -0.19])  # trunk into the -y face
    z = np.zeros((NUM_ENVS, 1, 0))
    return ag, _npcs(box[:, None], z, z, rng)


def _seesaw_state(env, rng):
    import jax.numpy as jnp

    from mqe_tpu.physics import soa as jsoa
    from mqe_tpu.physics.model import load_model

    E = NUM_ENVS
    ag = _agents(env, rng)
    eo = np.asarray(env.env_origins)
    pivot = eo + np.array([8.0, 0.0, 1.0])
    qs, qds = np.full((E, 1, 1), -0.2), rng.randn(E, 1, 1) * 0.3
    npc = _npcs(pivot[:, None], qs, qds, rng)
    npc["lin_vel"][:] = 0.0                                 # a welded base
    npc["ang_vel"][:] = 0.0
    # a point on the plank's top face, from the plank's pose
    m = load_model("seesaw", root_free=False)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32).reshape(E, -1))
    Rw, pw, _, _, _ = (np.asarray(x) for x in jsoa.fk_full(m, *(f32(npc[k]) for k in ACTOR_FIELDS)))
    on_plank = lambda e, x: pw[e, 1] + Rw[e, 1] @ np.array([x, 0.0, 0.015], np.float32)
    ag["pos"][0, 0] = on_plank(0, -1.0) + np.array([0.0, 0.0, 0.04])   # trunk on the plank
    ag["pos"][0, 1] = pivot[0] + np.array([-0.46, 0.0, -0.6])          # head into the pivot
    ag["pos"][1, 0] = on_plank(1, -1.6) + np.array([0.0, 0.0, 0.04])
    ag["pos"][1, 1] = pivot[1] + np.array([0.0, 0.0, 0.055])           # on the platform
    return ag, npc


def _balls_state(env, rng):
    ag = _agents(env, rng)
    ag["pos"][1, 0, 2] = 0.2                                # env 1: a crouching robot
    b0 = ag["pos"][:, 0] + np.array([0.27 + 0.11, 0.0, 0.0])  # at the head
    b1 = b0 + np.array([0.15, 0.02, 0.0])                   # into ball 0
    b1[1, 2] = 0.095                                        # env 1: on the ground
    z = np.zeros((NUM_ENVS, 2, 0))
    return ag, _npcs(np.stack([b0, b1], axis=1), z, z, rng)


def _anchor(env, rng):
    """The welded NPC anchor of a static-fixture task, where the env puts it."""
    pos = np.asarray(env.npc_init)[None, :, :3] + np.asarray(env.env_origins)[:, None] * [1, 1, 0]
    z = np.zeros((NUM_ENVS, 1, 0))
    return _npcs(pos, z, z, rng)


def _wrestling_state(env, rng):
    ag = _agents(env, rng)
    ring = np.asarray(env.static_geoms)[:, 0]               # (E, 8): kind, center, r, h/2
    on_top = lambda e, y: ring[e, 1:4] + np.array([0.0, y, ring[e, 5] + 0.26])
    ag["pos"][0, 0], ag["pos"][0, 1] = on_top(0, 1.0), on_top(0, -1.0)  # env 0: both on the ring
    ag["pos"][1, 0] = ring[1, 1:4] + np.array([-ring[1, 4] - 0.25, 0.0, 0.05])  # head into the side
    ag["pos"][1, 1] = on_top(1, -1.0)
    ag["lin_vel"] *= 0.1                                    # feet not lifting off the ring
    return ag, _anchor(env, rng)


def _bridge_state(env, rng):
    ag = _agents(env, rng)
    sg = np.asarray(env.static_geoms)                       # rows: deck, +x and -x platforms
    deck, plat = sg[:, 0], sg[:, 2]
    for e in range(NUM_ENVS):
        ag["pos"][e, 0] = deck[e, 1:4] + np.array([-1.0, 0.0, deck[e, 6] + 0.28])  # on the deck
    ag["pos"][0, 1] = plat[0, 1:4] + np.array([0.0, 0.3, plat[0, 6] + 0.28])       # on a platform
    ag["pos"][1, 1] = deck[1, 1:4] + np.array([0.5, -deck[1, 5] - 0.12, 0.0])  # into the side
    return ag, _anchor(env, rng)


def _ball_state(env, rng):
    ag = _agents(env, rng)
    ag["pos"][..., :2] += np.asarray(env.agent_init)[None, :, :2]  # at their spawn points
    ag["pos"][1, 2, 2] = 0.2                                # env 1: a crouching robot
    ball = ag["pos"][:, 2] + np.array([0.27 + 0.11, 0.0, 0.0])  # at robot 2's head
    z = np.zeros((NUM_ENVS, 1, 0))
    return ag, _npcs(ball[:, None], z, z, rng)


# case: (task, NPC model put in the task's place with 2 NPCs or "", state)
NPC_CASES = {"pushbox": ("go1pushbox", "", _pushbox_state),
             "seesaw": ("go1seesaw", "", _seesaw_state),
             "two-balls": ("go1pushbox", "ball", _balls_state)}
STATIC_CASES = {"wrestling-ring": ("go1wrestling", "", _wrestling_state),
                "bridge": ("go1bridge", "", _bridge_state),
                "football-ball": ("go1football-2vs2", "", _ball_state)}


def record_npc_substep(cases=tuple(NPC_CASES), table=NPC_CASES, substep=None) -> dict:
    """The record of one JAX `substep_batch` for each of `cases` of `table`
    (or of `substep(jscene, env, state, tau, npc_tau, dr, dt)`)."""
    import dataclasses

    import jax.numpy as jnp

    from mqe_tpu.envs.registry import make_mqe_env
    from mqe_tpu.physics import scene as JS
    from mqe_tpu.physics.model import load_model

    E = NUM_ENVS
    rec = {}
    for case in cases:
        task, npc_name, state = table[case]
        env = make_mqe_env(task, num_envs=E, seed=0)[0].env
        jscene = env.scene
        if npc_name:
            jscene = dataclasses.replace(jscene, npc=load_model(npc_name), num_npcs=2)
        A, N = jscene.num_agents, jscene.num_npcs
        rng = np.random.RandomState(2)
        ag, npc = state(env, rng)
        ex = dict(mu=rng.uniform(0.5, 1.5, E), payload=rng.rand(E, A),
                  com=rng.randn(E, A, 3) * 0.01)
        tau = rng.randn(E, A, 12) * 3.0
        npc_tau = rng.randn(E, N, jscene.npc.nq if N else 0) * 2.0
        f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
        ag, npc, ex = f32(ag), f32(npc), f32(ex)
        tau, npc_tau = tau.astype(np.float32), npc_tau.astype(np.float32)
        dt = env.sim_dt / env.subiters

        actors = lambda d: JS.ActorState(**{k: jnp.asarray(v) for k, v in d.items()})
        jstate = JS.PhysState(agents=actors(ag), npcs=actors(npc))
        jdr = JS.DomainRand(mu_scale=jnp.asarray(ex["mu"]), payload=jnp.asarray(ex["payload"]),
                            com_shift=jnp.asarray(ex["com"]), motor_strength=jnp.ones((E, A, 12)))
        jterrain = JS.Terrain(height=env.hf, origin=env.hf_origin, scale=env.hf_scale,
                              boxes=env.env_boxes, static_geoms=env.static_geoms)
        if substep is None:
            jnew, jc = JS.substep_batch(jscene, jterrain, jstate, jnp.asarray(tau),
                                        jnp.asarray(npc_tau), jdr, dt)
        else:
            jnew, jc = substep(jscene, env, jstate, jnp.asarray(tau), jnp.asarray(npc_tau),
                               jdr, dt)
        rec[f"{case}/task"], rec[f"{case}/npc"] = np.array(task), np.array(npc_name)
        rec[f"{case}/dt"] = np.array(dt)
        rec[f"{case}/tau"], rec[f"{case}/npc_tau"] = tau, npc_tau
        for k, v in ex.items():
            rec[f"{case}/dr/{k}"] = v
        for who, d, new in (("agents", ag, jnew.agents), ("npcs", npc, jnew.npcs)):
            for k in ACTOR_FIELDS:
                rec[f"{case}/{who}/{k}"] = d[k]
                rec[f"{case}/out/{who}/{k}"] = np.asarray(getattr(new, k))
        for k in ("sphere_force", "npc_sphere_force", "feet_force"):
            rec[f"{case}/contact/{k}"] = np.asarray(getattr(jc, k))
    return rec


# ---------------------------------------------------------------------------
# the training stack (torch_learn.npz, torch_go1gate_ppo_update.npz)
# ---------------------------------------------------------------------------

# narrow widths of the network tests: obs 7, actions 3
NARROW = dict(mlp=dict(hidden=(16, 8)), gru=dict(embed=(16,), rnn_size=8, head=(8,)),
              mat=dict(embed=16))
# the committed TrainStates the port loads: task -> (path, recurrent)
CHECKPOINTS = {"go1bridge": ("checkpoints/r5b/go1bridge_ppo_best.npz", False),
               "go1gate": ("checkpoints/rec/go1gate_ppo_best.npz", True)}
UPDATE_CFG = dict(rollout_len=4, num_minibatches=4, ppo_epochs=4)


def _net(kind, act_dim=3, **kw):
    from mqe_tpu.learn.mat import MATNetwork
    from mqe_tpu.learn.networks import ActorCritic, RecurrentActorCritic

    cls = {"mlp": ActorCritic, "gru": RecurrentActorCritic, "mat": MATNetwork}[kind]
    return cls(action_dim=act_dim, **kw)


def _init(net, kind, obs_dim, agents=3):
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    if kind == "gru":
        return net.init(key, jnp.zeros((1, obs_dim)), net.initial_state((1,)))
    if kind == "mat":
        return net.init(key, jnp.zeros((1, agents, obs_dim)),
                        jnp.zeros((1, agents, net.action_dim)))
    return net.init(key, jnp.zeros((1, obs_dim)))


def record_learn() -> dict:
    from types import SimpleNamespace

    import jax.numpy as jnp
    import optax

    from mqe_tpu.envs.registry import ENV_DICT, make_mqe_env
    from mqe_tpu.learn.mat import MATTrainer
    from mqe_tpu.learn.networks import gaussian_logp
    from mqe_tpu.learn.ppo import PPOConfig, PPOTrainer

    rng = np.random.RandomState(4)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    rec = {}
    with jax.disable_jit():
        # networks at narrow widths
        for kind, kw in NARROW.items():
            net = _net(kind, **kw)
            params = _init(net, kind, 7)
            rec.update(_flat(f"nets/{kind}/params", params))
            if kind == "gru":
                obs, h = f32(3, 5, 2, 7), f32(5, 2, kw["rnn_size"])
                rec[f"nets/{kind}/obs"], rec[f"nets/{kind}/h0"] = obs, h
                for t in range(3):
                    mean, log_std, value, h = net.apply(params, jnp.asarray(obs[t]), h)
                    rec.update(_flat(f"nets/{kind}/out/{t}", dict(
                        mean=mean, log_std=log_std, value=value, h=h)))
                continue
            if kind == "mat":
                obs, prev = f32(5, 3, 7), f32(5, 3, 3)
                rec[f"nets/{kind}/prev"] = prev
                out = net.apply(params, jnp.asarray(obs), jnp.asarray(prev))
            else:
                obs = f32(5, 2, 7)
                out = net.apply(params, jnp.asarray(obs))
            rec[f"nets/{kind}/obs"] = obs
            rec.update(_flat(f"nets/{kind}/out", dict(zip(("mean", "log_std", "value"), out))))

        # the committed checkpoints at full width
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for task, (path, recurrent) in CHECKPOINTS.items():
            kind = "gru" if recurrent else "mlp"
            with np.load(os.path.join(repo, path)) as data:
                obs_dim = data["leaf_00009" if recurrent else "leaf_00001"].shape[0]
                net = _net(kind)
                leaves, treedef = jax.tree_util.tree_flatten(_init(net, kind, obs_dim))
                params = jax.tree_util.tree_unflatten(
                    treedef, [jnp.asarray(data[f"leaf_{i:05d}"]) for i in range(len(leaves))])
            obs = f32(4, 2, obs_dim)
            rec[f"ckpt/{task}/obs"] = obs
            if recurrent:
                h = 0.5 * f32(4, 2, net.rnn_size)
                rec[f"ckpt/{task}/h"] = h
                mean, log_std, value, h_new = net.apply(params, jnp.asarray(obs), jnp.asarray(h))
                rec[f"ckpt/{task}/h_new"] = np.asarray(h_new)
            else:
                mean, log_std, value = net.apply(params, jnp.asarray(obs))
            rec.update(_flat(f"ckpt/{task}", dict(mean=mean, log_std=log_std, value=value)))

        # gaussian_logp
        m, ls, a = f32(6, 2, 3), 0.3 * f32(3), f32(6, 2, 3)
        rec.update({"logp/mean": m, "logp/log_std": ls, "logp/action": a,
                    "logp/out": np.asarray(gaussian_logp(m, ls, a))})

        # valuenorm, GAE with dones mid-trajectory, advantage normalisation
        cfg = PPOConfig()
        view = SimpleNamespace(cfg=cfg)
        T, E, A = 6, 3, 2
        traj = dict(reward=f32(T, E, A), value=f32(T, E, A), done=np.zeros((T, E), bool))
        traj["done"][1, 0] = traj["done"][3, 2] = traj["done"][4, 0] = True
        final_value = f32(E, A)
        rec.update(_flat("gae/in", dict(traj=traj, final_value=final_value,
                                        ret_mean=np.float32(0.7), ret_var=np.float32(2.5))))
        stats = SimpleNamespace(ret_mean=jnp.float32(0.7), ret_var=jnp.float32(2.5))
        vtraj, vfinal = PPOTrainer._valuenorm(view, stats, jax.tree.map(jnp.asarray, traj),
                                              jnp.asarray(final_value))
        advs, returns = PPOTrainer._gae(view, vtraj, vfinal)
        new_mean, new_var, norm = PPOTrainer._valuenorm_update(view, stats, returns)
        rec.update(_flat("gae/out", dict(
            value=vtraj["value"], final_value=vfinal, advs=advs, returns=returns,
            ret_mean=new_mean, ret_var=new_var, ret_norm=norm(returns),
            adv_norm=(advs - advs.mean()) / (advs.std() + 1e-8))))

        # _loss and its gradients: ppo, dppo, MAT
        for algo in ("ppo", "dppo", "mat"):
            kind = "mat" if algo == "mat" else "mlp"
            net = _net(kind, **NARROW[kind])
            params = _init(net, kind, 7)
            if kind == "mat":
                batch = dict(obs=f32(6, 3, 7), action=f32(6, 3, 3))
                prev = MATTrainer._shift_actions(jnp.asarray(batch["action"]))
                mean, log_std, _ = net.apply(params, jnp.asarray(batch["obs"]), prev)
                shape = (6, 3)
            else:
                batch = dict(obs=f32(12, 7), action=f32(12, 3))
                mean, log_std, _ = net.apply(params, jnp.asarray(batch["obs"]))
                shape = (12,)
            # old log-probs off the current ones: ratios exp(off) on both sides
            # of the clip, and in the first two rows 3.67 with a negative
            # advantage, past the dual clip (ratios of a PPO batch: within
            # [0.3, 4], so that float32 rounding stays at its usual scale)
            logp = np.asarray(gaussian_logp(mean, log_std, jnp.asarray(batch["action"])))
            off, adv = 0.4 * f32(*shape), f32(*shape)
            off.reshape(-1)[:2] = 1.3
            adv.reshape(-1)[:2] = -np.abs(adv.reshape(-1)[:2]) - 0.1
            batch.update(logp=(logp - off).astype(np.float32), adv=adv, ret=f32(*shape))
            cls = MATTrainer if kind == "mat" else PPOTrainer
            view = SimpleNamespace(cfg=PPOConfig(algo=algo), net=net,
                                   _shift_actions=MATTrainer._shift_actions)
            jb = jax.tree.map(jnp.asarray, batch)
            (loss, aux), grads = jax.value_and_grad(
                lambda p: cls._loss(view, p, jb), has_aux=True)(params)
            rec.update(_flat(f"loss/{algo}/params", params))
            rec.update(_flat(f"loss/{algo}/batch", batch))
            rec.update(_flat(f"loss/{algo}/out", dict(loss=loss, **aux)))
            rec.update(_flat(f"loss/{algo}/grads", grads))

        # three optimizer steps of clip + Adam, the second above the clip norm
        params = _init(_net("mlp", **NARROW["mlp"]), "mlp", 7)
        tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                         optax.adam(cfg.lr, eps=1e-5))
        opt_state = tx.init(params)
        rec.update(_flat("optim/params/0", params))
        for i, scale in enumerate((0.01, 1.0, 0.003)):
            g = jax.tree.map(lambda p: jnp.asarray(scale * f32(*p.shape)), params)
            rec[f"optim/gnorm/{i}"] = np.asarray(optax.global_norm(g))
            rec.update(_flat(f"optim/grads/{i}", g))
            upd, opt_state = tx.update(g, opt_state, params)
            params = optax.apply_updates(params, upd)
            rec.update(_flat(f"optim/params/{i + 1}", params))

    # reward-term names of every task
    for task in ENV_DICT:
        wrap, _ = make_mqe_env(task, num_envs=NUM_ENVS, seed=0)
        names = PPOTrainer(wrap, PPOConfig(), seed=0).term_names  # go1plane's: none
        rec[f"terms/{task}"] = np.array(names, dtype=str)
    return rec


def _start_state(wrap):
    """The go1gate "in-contact" start of torch_go1gate_step.npz as a JAX
    TaskState: the record's arrays put into a reset state's tree by path."""
    import jax.numpy as jnp

    template, _ = wrap.reset(jax.random.PRNGKey(0))
    prefix = "in-contact/start"
    with np.load(os.path.join(GOLDENS, "torch_go1gate_step.npz")) as f:
        start = {k: f[k] for k in f.files if k.startswith(prefix + "/")}
    paths = list(_flat(prefix, template))
    assert sorted(paths) == sorted(start), "the step record does not hold a whole state"
    treedef = jax.tree_util.tree_structure(template)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(start[p]) for p in paths])


def _narrow(trainer, kind):
    """The trainer with its network at the narrow widths of `NARROW`, its
    init params drawn as its constructor draws them (the first of
    jax.random.split(PRNGKey(seed)))."""
    trainer.net = _net(kind, trainer.act_dim, **NARROW[kind])
    key = jax.random.split(jax.random.PRNGKey(0))[0]
    import jax.numpy as jnp

    if kind == "mat":
        args = (jnp.zeros((1, trainer.A, trainer.obs_dim)), jnp.zeros((1, trainer.A, trainer.act_dim)))
    else:
        args = (jnp.zeros((1, trainer.obs_dim)),)
    trainer.init_params = trainer.net.init(key, *args)
    return trainer


def record_ppo_update() -> dict:
    from mqe_tpu.envs.registry import make_mqe_env
    from mqe_tpu.learn.mat import MATTrainer
    from mqe_tpu.learn.ppo import PPOConfig, PPOTrainer

    wrap, _ = make_mqe_env("go1gate", num_envs=NUM_ENVS, seed=0)
    tr = _narrow(PPOTrainer(wrap, PPOConfig(**UPDATE_CFG), seed=0), "mlp")
    ts = tr.init_state().replace(env_state=_start_state(wrap))
    T, E, A = tr.cfg.rollout_len, tr.E, tr.A
    rec = _flat("init/params", ts.params)
    # the draws of _rollout and of the epochs, split from the state's key as
    # PPOTrainer splits them
    key, noise = ts.key, []
    for _ in range(T):
        key, k_act, _ = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k_act, (E, A, tr.act_dim))))
    rec["noise"] = np.stack(noise)

    def perms(key, n):
        out = []
        for _ in range(tr.cfg.ppo_epochs):
            key, kperm = jax.random.split(key)
            out.append(np.asarray(jax.random.permutation(kperm, n)))
        return np.stack(out)

    rollout = jax.jit(tr._rollout)(ts)
    env_state, rkey, traj, final_value, ep_acc, _ = rollout
    assert np.array_equal(np.asarray(rkey), np.asarray(key)), "the rollout's key chain"
    rec.update(_flat("traj", traj))
    rec["final_value"] = np.asarray(final_value)
    rec.update(_flat("out_env", env_state))
    rec.update(_flat("ep_acc", ep_acc))
    rec["perm"] = perms(rkey, T * E * A)
    tr._rollout = lambda _ts: rollout  # the update learns from the recorded rollout
    after, metrics = jax.jit(tr._update_impl)(ts)
    rec.update(_flat("after/params", after.params))
    rec.update(_flat("after/metrics", metrics))
    rec["after/ret_mean"], rec["after/ret_var"] = np.asarray(after.ret_mean), np.asarray(after.ret_var)

    mtr = _narrow(MATTrainer(wrap, PPOConfig(algo="mat", **UPDATE_CFG), seed=0), "mat")
    mts = mtr.init_state()
    rec.update(_flat("mat/init/params", mts.params))
    rec["mat/perm"] = perms(rkey, T * E)
    mtr._rollout = lambda _ts: rollout
    mafter, mmetrics = jax.jit(mtr._update_impl)(mts)
    rec.update(_flat("mat/after/params", mafter.params))
    rec.update(_flat("mat/after/metrics", mmetrics))
    rec["mat/after/ret_mean"] = np.asarray(mafter.ret_mean)
    rec["mat/after/ret_var"] = np.asarray(mafter.ret_var)
    rec["done"] = np.asarray(traj["done"])
    return rec


# ---------------------------------------------------------------------------
# locomotion training and the `policy` backend
# ---------------------------------------------------------------------------

LOCO_ENVS = 4


def _loco_cfg(backend="residual"):
    from mqe_tpu.learn.locomotion_env import LocomotionTrainCfg

    class Cfg(LocomotionTrainCfg):
        class control(LocomotionTrainCfg.control):
            locomotion_backend = backend

    return Cfg


def _command_draws(key, n, resample_prob=0.0):
    """The draws of LocomotionEnv._sample_commands (and of the fast switch)
    from `key`, by the names the port takes them under."""
    if resample_prob > 0.0:
        key, k_fast = jax.random.split(key)
    k1, k2, k3 = jax.random.split(key, 3)
    out = {"cmd_vx": jax.random.uniform(k1, (n,), minval=-1.0, maxval=1.0),
           "cmd_vy": jax.random.uniform(k2, (n,), minval=-0.6, maxval=0.6),
           "cmd_wz": jax.random.uniform(k3, (n,), minval=-1.0, maxval=1.0)}
    if resample_prob > 0.0:
        out["cmd_switch"] = jax.random.uniform(k_fast, (n,))
    return {k: np.asarray(v) for k, v in out.items()}


def _gait_draws(key, n):
    """The draws of LocomotionEnv._sample_gaits from `key`."""
    ku, kg = jax.random.split(key)
    return {"gait_switch": np.asarray(jax.random.uniform(ku, (n,))),
            "gait_other": np.asarray(jax.random.randint(kg, (n,), 1, 4))}


def _loco_step_draws(env, key):
    """{name: array} of everything LocomotionEnv._step_impl draws from `key`,
    and its fresh reset state."""
    k_reset, k_cmd, k_gait = jax.random.split(key, 3)
    draws = _command_draws(k_cmd, env.num_envs, env.resample_prob)
    if env.multi_gait > 0.0:
        draws.update(_gait_draws(k_gait, env.num_envs))
    return draws, env.env._reset_all(k_reset)


def _finish_start(ts):
    """Env 0 one step short of its timeout, its episode tracked well enough
    to widen the command range; env 1 one step short of the 5 s resample."""
    import jax.numpy as jnp

    E = ts.env.episode_length.shape[0]
    length = np.zeros(E, np.int32)
    length[0], length[1] = 499, 249
    acc = np.zeros(E, np.float32)
    acc[0] = 450.0
    return ts.replace(env=ts.env.replace(episode_length=jnp.asarray(length)),
                      track_acc=jnp.asarray(acc))


# case: (backend, multi_gait, resample_prob, warm steps, the start's edit)
LOCO_CASES = {"residual-lag": ("residual", 0.0, 0.0, 0, None),
              "policy": ("policy", 0.0, 0.0, 0, None),
              "multi-gait": ("residual", 0.5, 0.5, 0, None),
              "policy-warm": ("policy", 0.0, 0.0, 10, None),
              "finish": ("residual", 0.5, 0.5, 10, _finish_start)}


def record_locomotion() -> dict:
    """LocomotionEnv at LOCO_ENVS envs: for each of LOCO_CASES, the reset
    from PRNGKey(0) with its draws ("<case>/reset/..."), the start (the reset
    state, or the state after the case's warm steps, whose actions come
    first and keys from PRNGKey(1); edited for "finish"), actions
    rl_prescale(N(0, 1)) from RandomState(3), and one step with PRNGKey(7):
    its draws, its fresh state, the state, obs, reward, done, reset_mask,
    time_outs and each reward term. From the reset the lag FIFO holds no
    action yet, so the warmed cases are those in which the actions reach
    the actuators."""
    from mqe_tpu.learn.locomotion_env import LocomotionEnv

    rec = {}
    for case, (backend, multi_gait, resample_prob, warm, edit) in LOCO_CASES.items():
        env = LocomotionEnv(num_envs=LOCO_ENVS, seed=0, cfg=_loco_cfg(backend),
                            resample_prob=resample_prob, multi_gait=multi_gait)
        key = jax.random.PRNGKey(0)
        ts, obs = env.reset(key)
        k1, k2 = jax.random.split(key)
        reset_draws = _command_draws(k2, LOCO_ENVS)
        if multi_gait > 0.0:
            reset_draws.update(_gait_draws(jax.random.fold_in(key, 7), LOCO_ENVS))
        for k, v in reset_draws.items():
            rec[f"{case}/reset/draws/{k}"] = v
        rec[f"{case}/reset/obs"] = np.asarray(obs)
        rec.update(_flat(f"{case}/reset/state", ts))
        acts = np.random.RandomState(3).randn(warm + 1, LOCO_ENVS, 1, 12).astype(np.float32)
        acts = np.asarray(env.rl_prescale(acts))
        key = jax.random.PRNGKey(1)
        for t in range(warm):
            key, k = jax.random.split(key)
            ts = env.step(ts, acts[t], k)[0]
        if edit is not None:
            ts = edit(ts)
        acts = acts[warm]
        step_key = jax.random.PRNGKey(7)
        draws, fresh = _loco_step_draws(env, step_key)
        ts1, obs1, rew, done, info = env.step(ts, acts, step_key)
        rec.update(_flat(f"{case}/start", ts))
        rec[f"{case}/actions"] = acts
        for k, v in draws.items():
            rec[f"{case}/draws/{k}"] = v
        rec.update(_flat(f"{case}/fresh", fresh))
        rec.update(_flat(f"{case}/out", ts1))
        rec[f"{case}/obs"], rec[f"{case}/reward"] = np.asarray(obs1), np.asarray(rew)
        rec[f"{case}/done"] = np.asarray(done)
        rec[f"{case}/reset_mask"] = np.asarray(info["reset_mask"])
        rec[f"{case}/time_outs"] = np.asarray(info["time_outs"])
        rec.update(_flat(f"{case}/terms", info["reward_terms"]))
    return rec


# the walk-these-ways body MLP at its published widths, weights drawn
WTW_SIZES = (2100 + 2, 512, 256, 128, 12)


def wtw_params(seed=5):
    """JAX `mlp_apply` params {"w": [(in, out)], "b": [...], "act": "elu"}
    of the walk-these-ways body MLP, drawn from RandomState(seed) with
    1/sqrt(fan_in) kernels (the reference's weights are not in the repo)."""
    rng = np.random.RandomState(seed)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(WTW_SIZES[:-1], WTW_SIZES[1:])]
    bs = [(0.1 * rng.randn(b)).astype(np.float32) for b in WTW_SIZES[1:]]
    return {"w": ws, "b": bs, "act": "elu"}


def _policy_cfg(pd_augment):
    from mqe_tpu.envs.tasks import Go1PlaneCfg

    class Cfg(Go1PlaneCfg):
        class control(Go1PlaneCfg.control):
            locomotion_backend = "policy"
            policy_pd_augment = pd_augment

    return Cfg


class _AssetsWithout:
    """Points `mqe_tpu.ASSETS_DIR` at a temporary copy of the assets without
    `name`, inside this process only; nothing under mqe_tpu/ is written."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        import shutil
        import tempfile

        import mqe_tpu

        self.old, self.tmp = mqe_tpu.ASSETS_DIR, tempfile.mkdtemp()
        for f in os.listdir(self.old):
            if f != self.name:
                shutil.copy(os.path.join(self.old, f), self.tmp)
        mqe_tpu.ASSETS_DIR = self.tmp
        return self.tmp

    def __exit__(self, *exc):
        import shutil

        import mqe_tpu

        mqe_tpu.ASSETS_DIR = self.old
        shutil.rmtree(self.tmp)


def record_policy_backend() -> dict:
    """The `policy` backend on go1plane at NUM_ENVS envs, one step each with
    PRNGKey(7) and actions from RandomState(3):
      - "npz", "npz-pd": the body policy of assets/body_policy.npz, with
        policy_pd_augment False and True, from the "in-contact" start of
        torch_go1plane_step.npz;
      - "wtw": the assets without body_policy.npz (hist_len 30), the body MLP
        of `wtw_params()` installed by load_locomotion_policy, from the state
        after 3 steps from the reset of PRNGKey(0).
    And "torques/pd0", "torques/pd1": one `_torques` call from the "npz"
    start with its actions' locomotion action, PD gated off and on."""
    import jax.numpy as jnp

    from mqe_tpu.envs.wrappers import EmptyWrapper
    from mqe_tpu.envs.go1_env import Go1Env

    rec = {}
    nact = EmptyWrapper(Go1Env(_policy_cfg(False), num_envs=NUM_ENVS, seed=0)).num_agents
    acts = np.random.RandomState(3).uniform(-1, 1, (4, NUM_ENVS, nact, 3)).astype(np.float32)
    with np.load(os.path.join(GOLDENS, "torch_go1plane_step.npz")) as f:
        plane = {k: f[k] for k in f.files}
    for case, pd in (("npz", False), ("npz-pd", True)):
        wrap = EmptyWrapper(Go1Env(_policy_cfg(pd), num_envs=NUM_ENVS, seed=0))
        assert wrap.env.hist_len == 0 and callable(wrap.env.body_policy_params)
        template, _ = wrap.reset(jax.random.PRNGKey(0))
        prefix = "in-contact/start"
        start = {k: v for k, v in plane.items() if k.startswith(prefix + "/")}
        paths = list(_flat(prefix, template))
        assert sorted(paths) == sorted(start)
        ts0 = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template),
                                           [jnp.asarray(start[p]) for p in paths])
        ts1, obs, rew, done, _ = wrap.step(ts0, acts[0], jax.random.PRNGKey(7))
        rec.update(_flat(f"{case}/start", ts0))
        rec.update(_flat(f"{case}/out", ts1))
        rec[f"{case}/actions"] = acts[0]
        rec[f"{case}/obs"], rec[f"{case}/reward"] = np.asarray(obs), np.asarray(rew)
        rec[f"{case}/done"] = np.asarray(done)
        # one _torques call with the step's locomotion action
        env = wrap.env
        cmd = jnp.clip(jnp.asarray(acts[0]) * jnp.asarray([2.0, 0.5, 0.5]), -1.0, 1.0)
        action = env._locomotion_action(ts0.env, cmd)[0]
        tau, err_hist, lag, target = env._torques(ts0.env, action)
        rec[f"torques/pd{int(pd)}/action"] = np.asarray(action)
        rec[f"torques/pd{int(pd)}/tau"] = np.asarray(tau)
    params = wtw_params()
    with _AssetsWithout("body_policy.npz"):
        wrap = EmptyWrapper(Go1Env(_policy_cfg(False), num_envs=NUM_ENVS, seed=0))
    env = wrap.env
    assert env.hist_len == 30 and env.body_policy_params is None
    env.load_locomotion_policy({"w": [jnp.asarray(w) for w in params["w"]],
                                "b": [jnp.asarray(b) for b in params["b"]], "act": "elu"})
    ts, _ = wrap.reset(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    for t in range(3):
        key, k = jax.random.split(key)
        ts = wrap.step(ts, acts[1 + t], k)[0]
    ts1, obs, rew, done, _ = wrap.step(ts, acts[0], jax.random.PRNGKey(7))
    rec.update(_flat("wtw/start", ts))
    rec.update(_flat("wtw/out", ts1))
    rec["wtw/actions"] = acts[0]
    rec["wtw/obs"], rec["wtw/reward"] = np.asarray(obs), np.asarray(rew)
    rec["wtw/done"] = np.asarray(done)
    return rec


def _events_cfg():
    """go1gate with push (every step), action lag, tanh and delta command
    clipping on, and the locomotion training's termination thresholds (the
    task's pitch threshold, 1.6, lies past the pitch's range)."""
    from mqe_tpu.envs.tasks import Go1GateCfg

    class Cfg(Go1GateCfg):
        class domain_rand(Go1GateCfg.domain_rand):
            push_robots = randomize_lag_timesteps = True
            push_interval_s = 0.02
            lag_timesteps = 6

        class normalization(Go1GateCfg.normalization):
            clip_actions_method = "tanh"
            clip_actions_delta = 0.1

        class termination(Go1GateCfg.termination):
            termination_terms = ["roll", "pitch", "z_low"]
            roll_kwargs = dict(threshold=0.8)
            pitch_kwargs = dict(threshold=1.0)
            z_low_kwargs = dict(threshold=0.12)

    return Cfg


EVENT_ENVS = 4


def _tilt(q, axis, angle):
    """Quaternion (xyzw) q rotated by `angle` about the world `axis`."""
    import jax.numpy as jnp

    from mqe_tpu.ops import quat as quat_ops

    r = np.zeros(4, np.float32)
    r[axis] = np.sin(angle / 2)
    r[3] = np.cos(angle / 2)
    return quat_ops.quat_mul(jnp.asarray(r), q)


def record_events() -> dict:
    """Queue C item 5: go1gate (`_events_cfg`) at EVENT_ENVS envs, reset
    with PRNGKey(0) and stepped WARM_STEPS times (actions uniform(-1, 1)
    from RandomState(3), keys from PRNGKey(1)). Two cases, one step each
    with PRNGKey(7), recording its push draw ("push_vel") and fresh state:
      - "push-lag-clip": from the warmed state;
      - "terminations": from the warmed state with env 0 rolled by 1.2 rad,
        env 1 pitched by 1.3 rad, env 2 lowered to z 0.09 and env 3's trunk
        put into the ground (z 0.03): roll, pitch, z_low and collide.
    The step's pre-reset flags stand in its out state ("out/env/done",
    "collide", "r_term", "p_term")."""
    from mqe_tpu.envs.go1_env import Go1Env
    from mqe_tpu.envs.wrappers import Go1GateWrapper

    E = EVENT_ENVS
    wrap = Go1GateWrapper(Go1Env(_events_cfg(), num_envs=E, seed=0))
    ts, _ = wrap.reset(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    acts = rng.uniform(-1, 1, (WARM_STEPS + 1, E, 2, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    for t in range(WARM_STEPS):
        key, k = jax.random.split(key)
        ts = wrap.step(ts, acts[t], k)[0]
    ag = ts.env.phys.agents
    quat = ag.quat.at[0].set(_tilt(ag.quat[0], 0, 1.2)).at[1].set(_tilt(ag.quat[1], 1, 1.3))
    pos = ag.pos.at[2, :, 2].set(0.09).at[3, :, 2].set(0.03)
    events = ts.replace(env=ts.env.replace(phys=ts.env.phys.replace(
        agents=ag.replace(quat=quat, pos=pos))))
    step_key = jax.random.PRNGKey(7)
    _, k_push, k_reset, _ = jax.random.split(step_key, 4)
    mv = wrap.env.cfg.domain_rand.max_push_vel_xy
    push = np.asarray(jax.random.uniform(k_push, (E, 2, 2), minval=-mv, maxval=mv))
    fresh = wrap.env._reset_all(k_reset)
    rec = {}
    for case, ts0 in (("push-lag-clip", ts), ("terminations", events)):
        ts1, obs, rew, done, _ = wrap.step(ts0, acts[WARM_STEPS], step_key)
        rec.update(_flat(f"{case}/start", ts0))
        rec.update(_flat(f"{case}/out", ts1))
        rec.update(_flat(f"{case}/fresh", fresh))
        rec[f"{case}/push_vel"] = push
        rec[f"{case}/actions"] = acts[WARM_STEPS]
        rec[f"{case}/obs"], rec[f"{case}/reward"] = np.asarray(obs), np.asarray(rew)
        rec[f"{case}/done"] = np.asarray(done)
    return rec


def record_loco_ppo_update() -> dict:
    """One PPOTrainer update of LocomotionEnv (residual, lag on) at NUM_ENVS
    envs, `UPDATE_CFG`, the network at `NARROW` widths (obs 70, actions 12),
    seed-0 init params, from the trainer's own reset ("start/..."): the
    action noise ("noise") and each step's command draws ("draws/<name>",
    (T, E)), the rollout, the epochs' permutations and the params after."""
    from mqe_tpu.learn.locomotion_env import LocomotionEnv
    from mqe_tpu.learn.ppo import PPOConfig, PPOTrainer

    env = LocomotionEnv(num_envs=NUM_ENVS, seed=0, cfg=_loco_cfg("residual"))
    tr = _narrow(PPOTrainer(env, PPOConfig(ent_coef=1e-3, lr=3e-4, **UPDATE_CFG), seed=0), "mlp")
    ts = tr.init_state()
    T, E, A = tr.cfg.rollout_len, tr.E, tr.A
    rec = _flat("init/params", ts.params)
    rec.update(_flat("start", ts.env_state))
    key, noise, draws = ts.key, [], []
    for _ in range(T):
        key, k_act, k_env = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k_act, (E, A, tr.act_dim))))
        draws.append(_loco_step_draws(env, k_env)[0])
    rec["noise"] = np.stack(noise)
    for k in draws[0]:
        rec[f"draws/{k}"] = np.stack([d[k] for d in draws])
    rollout = jax.jit(tr._rollout)(ts)
    env_state, rkey, traj, final_value, ep_acc, _ = rollout
    assert np.array_equal(np.asarray(rkey), np.asarray(key)), "the rollout's key chain"
    assert not np.asarray(traj["done"]).any(), "an env finished: its fresh state is not recorded"
    rec.update(_flat("traj", traj))
    rec["final_value"] = np.asarray(final_value)
    rec.update(_flat("out_env", env_state))
    rec.update(_flat("ep_acc", ep_acc))
    perm = []
    for _ in range(tr.cfg.ppo_epochs):
        rkey, kperm = jax.random.split(rkey)
        perm.append(np.asarray(jax.random.permutation(kperm, T * E * A)))
    rec["perm"] = np.stack(perm)
    tr._rollout = lambda _ts: rollout
    after, metrics = jax.jit(tr._update_impl)(ts)
    rec.update(_flat("after/params", after.params))
    rec.update(_flat("after/metrics", metrics))
    rec["after/ret_mean"] = np.asarray(after.ret_mean)
    rec["after/ret_var"] = np.asarray(after.ret_var)
    rec["done"] = np.asarray(traj["done"])
    return rec

# ---------------------------------------------------------------------------
# terrain builders, the curriculum, the cameras, the MPC (torch_terrain.npz,
# torch_camera.npz, torch_mpc.npz)
# ---------------------------------------------------------------------------

# Legacy builds: the default proportions (every tile kind but the gap and the
# flat-noise tile), six proportions (the gap) and a sum below one (the
# flat-noise tile); 0.1 m cells and 4 m tiles keep the record small
LEGACY_CASES = {
    "defaults": dict(num_rows=3, num_cols=10, terrain_length=4.0, terrain_width=4.0,
                     horizontal_scale=0.1),
    "gap": dict(num_rows=3, num_cols=5, terrain_length=4.0, terrain_width=4.0,
                horizontal_scale=0.1, terrain_proportions=[0.1, 0.1, 0.2, 0.2, 0.2, 0.2]),
    "flat-noise": dict(num_rows=2, num_cols=5, terrain_length=4.0, terrain_width=4.0,
                       horizontal_scale=0.1, terrain_proportions=[0.2, 0.2, 0.2, 0.2, 0.1]),
}
PERLIN_CASES = {
    "perlin": dict(num_rows=2, num_cols=3, terrain_length=4.0, terrain_width=4.0,
                   horizontal_scale=0.05, TerrainPerlin_kwargs=dict(zScale=0.12, frequency=10)),
}
BUILD_FIELDS = ("height", "origin", "boxes", "env_origins", "agent_origins")


def _curr_cfg(base):
    """tests/test_envs.py::test_terrain_curriculum_levels_progress's config:
    one robot, 4 envs, a Legacy heightfield of 4 rows x 2 columns of 8 m
    tiles at Go1Cfg's 0.025 m cells, the curriculum on, 2 s episodes."""
    class CurrCfg(base):
        class env(base.env):
            num_envs = 4
            num_agents = 1
            num_npcs = 0
            episode_length_s = 2.0

        class terrain(base.terrain):
            mesh_type = "heightfield"
            selected = "Legacy"
            curriculum = True
            num_rows = 4
            num_cols = 2
            terrain_length = 8.0
            terrain_width = 8.0

    return CurrCfg


def _gate_rows_cfg(base, camera=False, perlin=False, rows=2):
    """A task's config with `rows` rows of its track and the curriculum on
    (rows None: the task's own terrain), the onboard depth and RGB camera,
    or perlin ground noise."""
    class Cfg(base):
        class terrain(base.terrain):
            if rows is not None:
                num_rows = rows
                curriculum = True
            BarrierTrack_kwargs = dict(base.terrain.BarrierTrack_kwargs,
                                       add_perlin_noise=perlin)

        class obs(base.obs):
            class cfgs(base.obs.cfgs):
                depth_image = camera
                rgb_image = camera

    return Cfg


def _step_record(rec, prefix, env, state, cmds, key):
    """One Go1Env step of `state` under `cmds` with `key`: the start, the
    draws the port takes by name ("fresh", the reset state the step drew
    for the levels it chose; "curr_level", the curriculum's random level),
    the step's state, observation base_pos and done."""
    import jax.numpy as jnp

    _, _, k_reset, k_lv = jax.random.split(key, 4)
    out, obs, done, _ = env.step(state, jnp.asarray(cmds), key)
    rec.update(_flat(f"{prefix}/start", state))
    rec.update(_flat(f"{prefix}/out", out))
    rec.update(_flat(f"{prefix}/fresh", env._reset_all(k_reset, out.terrain_levels)))
    rec[f"{prefix}/curr_level"] = np.asarray(
        jax.random.randint(k_lv, (env.num_envs,), 0, getattr(env, "num_levels", 1)))
    rec[f"{prefix}/commands"] = np.asarray(cmds)
    rec[f"{prefix}/base_pos"] = np.asarray(obs.base_pos)
    rec[f"{prefix}/done"] = np.asarray(done)
    return out


def record_terrain() -> dict:
    """torch_terrain.npz:
      - "legacy/<case>/<field>", "perlin/<case>/<field>": the builds of
        `LEGACY_CASES` (seed 3) and `PERLIN_CASES` (seed 1);
      - "curr/step1", "curr/step2": the two steps of
        test_terrain_curriculum_levels_progress (`_curr_cfg`): from the reset
        of PRNGKey(0) with the robots moved past curr_up_dist and every
        episode at its end (key PRNGKey(1)); then from that step's state at
        its end with commands of ones (key PRNGKey(2)); `_step_record`;
      - "hf/step": a step on that heightfield within an episode: from the
        reset of PRNGKey(3) after 10 steps of 0.5 forward (keys split from
        PRNGKey(4)), key PRNGKey(5);
      - "gate-rows/step": go1gate on two rows with the curriculum on
        (`_gate_rows_cfg`), reset with PRNGKey(0) onto the other row of each
        env, 10 steps of commands drawn from RandomState(3), then a step
        with key PRNGKey(7); "gate-rows/grid_env_origins" and
        "gate-rows/env_rows".
    """
    from mqe_tpu.envs.config import Go1Cfg
    from mqe_tpu.envs.go1_env import Go1Env
    from mqe_tpu.envs.tasks import Go1GateCfg
    from mqe_tpu.terrain import get_terrain_builder

    import jax.numpy as jnp

    rec = {}
    for kind, cases, seed in (("legacy", LEGACY_CASES, 3), ("perlin", PERLIN_CASES, 1)):
        name = "Legacy" if kind == "legacy" else "TerrainPerlin"
        for case, cfg in cases.items():
            b = get_terrain_builder(name)(cfg, 2).build(seed=seed)
            for f in BUILD_FIELDS:
                rec[f"{kind}/{case}/{f}"] = np.asarray(getattr(b, f))

    env = Go1Env(_curr_cfg(Go1Cfg), num_envs=4, seed=0)
    state = env._reset_all(jax.random.PRNGKey(0))
    ag = state.phys.agents
    state = state.replace(
        phys=state.phys.replace(agents=ag.replace(pos=ag.pos.at[..., 0].add(env.curr_up_dist + 1.0))),
        episode_length=jnp.full((4,), env.max_episode_length, dtype=jnp.int32))
    out = _step_record(rec, "curr/step1", env, state, np.zeros((4, 1, 3), np.float32),
                       jax.random.PRNGKey(1))
    state = out.replace(episode_length=jnp.full((4,), env.max_episode_length, dtype=jnp.int32),
                        commands=jnp.ones((4, 1, 3)))
    _step_record(rec, "curr/step2", env, state, np.ones((4, 1, 3), np.float32),
                 jax.random.PRNGKey(2))

    state = env._reset_all(jax.random.PRNGKey(3))
    cmds = np.zeros((4, 1, 3), np.float32)
    cmds[..., 0] = 0.5
    key = jax.random.PRNGKey(4)
    for _ in range(10):
        key, k = jax.random.split(key)
        state = env.step(state, jnp.asarray(cmds), k)[0]
    _step_record(rec, "hf/step", env, state, cmds, jax.random.PRNGKey(5))

    genv = Go1Env(_gate_rows_cfg(Go1GateCfg), num_envs=NUM_ENVS, seed=0)
    assert genv.curriculum
    state = genv._reset_all(jax.random.PRNGKey(0), jnp.asarray(1 - genv.env_rows, dtype=jnp.int32))
    acts = np.random.RandomState(3).uniform(-1, 1, (11, NUM_ENVS, 2, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    for t in range(10):
        key, k = jax.random.split(key)
        state = genv.step(state, jnp.asarray(acts[t]), k)[0]
    _step_record(rec, "gate-rows/step", genv, state, acts[10], jax.random.PRNGKey(7))
    rec["gate-rows/grid_env_origins"] = np.asarray(genv.grid_env_origins)
    rec["gate-rows/env_rows"] = np.asarray(genv.env_rows)
    for k in ("curr/step1", "curr/step2", "hf/step", "gate-rows/step"):
        print(k, "levels", rec[f"{k}/start/terrain_levels"], "->", rec[f"{k}/out/terrain_levels"],
              "done", rec[f"{k}/done"])
    return rec


def _recorded_start(wrap, task, case="in-contact"):
    """A start state of torch_<task>_step.npz as a JAX TaskState of `wrap`."""
    import jax.numpy as jnp

    template, _ = wrap.reset(jax.random.PRNGKey(0))
    prefix = f"{case}/start"
    with np.load(os.path.join(GOLDENS, f"torch_{task}_step.npz")) as f:
        start = {k: f[k] for k in f.files if k.startswith(prefix + "/")}
    paths = list(_flat(prefix, template))
    assert sorted(paths) == sorted(start), "the step record does not hold a whole state"
    treedef = jax.tree_util.tree_structure(template)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(start[p]) for p in paths])


def record_camera() -> dict:
    """torch_camera.npz: the onboard depth and RGB images of `_observations`
    (op by op) with the camera on, "<case>/state/..." (an EnvState) beside
    "<case>/depth" and "<case>/rgb":
      - "gate/post-reset": go1gate's reset of PRNGKey(0);
      - "gate/in-contact": the "in-contact" start of torch_go1gate_step.npz;
      - "sheep/in-contact": go1sheep-easy's (the NPC roots' impostors);
      - "perlin-gate": go1gate's ground with perlin noise (the heightfield
        march) at go1gate's in-contact state;
      - "gate-rows": go1gate on two rows with the curriculum on, reset with
        PRNGKey(0) onto the other row of each env (each env's wall boxes
        and origins of its level).
    """
    from mqe_tpu.envs.go1_env import Go1Env
    from mqe_tpu.envs.registry import make_mqe_env
    from mqe_tpu.envs.tasks import Go1GateCfg, SingleSheepCfg

    import jax.numpy as jnp

    rec = {}

    def put(case, env, state):
        ob = env._observations(state)
        rec.update(_flat(f"{case}/state", state))
        rec[f"{case}/depth"] = np.asarray(ob.depth_image)
        rec[f"{case}/rgb"] = np.asarray(ob.rgb_image)

    for task, base in (("go1gate", Go1GateCfg), ("go1sheep-easy", SingleSheepCfg)):
        cam = _gate_rows_cfg(base, camera=True, rows=None)
        wrap, _ = make_mqe_env(task, num_envs=NUM_ENVS, seed=0, custom_cfg=lambda _c: cam)
        label = "gate" if task == "go1gate" else "sheep"
        if task == "go1gate":
            put("gate/post-reset", wrap.env, wrap.reset(jax.random.PRNGKey(0))[0].env)
        put(f"{label}/in-contact", wrap.env, _recorded_start(wrap, task).env)
    pwrap, _ = make_mqe_env("go1gate", num_envs=NUM_ENVS, seed=0,
                            custom_cfg=lambda _c: _gate_rows_cfg(Go1GateCfg, camera=True,
                                                                 perlin=True, rows=None))
    assert pwrap.env.scene.flat_height is None
    put("perlin-gate", pwrap.env, _recorded_start(pwrap, "go1gate").env)
    genv = Go1Env(_gate_rows_cfg(Go1GateCfg, camera=True), num_envs=NUM_ENVS, seed=0)
    put("gate-rows", genv, genv._reset_all(
        jax.random.PRNGKey(0), jnp.asarray(1 - genv.env_rows, dtype=jnp.int32)))
    return rec


# the MPC record: go1gate's two robots, the controller's horizon
MPC_H = 20
MPC_ENVS = 2


def _ilqr_parts(solve):
    """The solver's inner functions (`backward`, `forward`, ...), read from
    the closure of the JAX package's `solve` (`linearize` from `backward`'s)."""
    return dict(zip(solve.__code__.co_freevars, (c.cell_contents for c in solve.__closure__)))


def _mpc_problem(task, A=2):
    """(dynamics, stage, final, cfg) of CommandMPC's default set-up for
    `task` at A robots: the default CommandModel, the RL envelope limits,
    H = MPC_H, 8 iterations."""
    from mqe_tpu.mpc import costs as C
    from mqe_tpu.mpc.command_model import CommandModel, joint_dynamics
    from mqe_tpu.mpc.ilqr import ILQRConfig

    lim = tuple([1.0, 0.5, 0.5] * A)
    cfg = ILQRConfig(horizon=MPC_H, n_iters=8, u_min=tuple(-v for v in lim), u_max=lim)
    stage, final = {"gate": C.gate_cost, "pushbox": C.pushbox_cost,
                    "waypoint": C.waypoint_cost}[task](A)
    return joint_dynamics(CommandModel(dt=0.1, num_agents=A)), stage, final, cfg


def _mpc_inputs(task, rng, A=2):
    """x0 (E, A*6), u_init (E, H, A*3) and args of `task` for MPC_ENVS envs,
    drawn from `rng` around go1gate's start: robots near x = 0.5, y = +-0.5."""
    E = MPC_ENVS
    x0 = np.zeros((E, A, 6), np.float32)
    x0[..., 0] = 0.5 + 0.2 * rng.randn(E, A)
    x0[..., 1] = np.array([0.5, -0.5])[:A] + 0.1 * rng.randn(E, A)
    x0[..., 2] = 0.2 * rng.randn(E, A)
    x0[..., 3:] = 0.2 * rng.randn(E, A, 3)
    u0 = (0.3 * rng.randn(E, MPC_H, A * 3)).astype(np.float32)
    if task == "gate":
        args = {"gate": np.stack([3.8 + 0.1 * rng.randn(E), 0.4 * rng.randn(E)], -1),
                "goal_x": np.full(E, 6.1)}
    elif task == "pushbox":
        args = {"box": np.stack([2.0 + 0.3 * rng.randn(E), 0.3 * rng.randn(E)], -1),
                "push_dir": np.tile([1.0, 0.0], (E, 1))}
    else:
        args = {"targets": x0[..., :2] + np.array([3.0, 0.0])}
    return x0.reshape(E, -1), u0, {k: v.astype(np.float32) for k, v in args.items()}


def _alpha_trace(solve, x0, u_init, args):
    """The JAX solve's own iteration (mqe_tpu/mpc/ilqr.py: solve's
    `iteration`), op for op with the closure's functions, for one problem;
    returns the index of the chosen step size and whether the cost
    improved, each iteration, and the final (us, cost)."""
    import jax.numpy as jnp

    p = _ilqr_parts(solve)
    cfg, alphas = p["cfg"], p["alphas"]
    us = jnp.clip(u_init, jnp.asarray(cfg.u_min), jnp.asarray(cfg.u_max))
    xs = p["rollout"](x0, us, args)
    cost = p["total_cost"](xs, us, args)
    reg = jnp.asarray(cfg.reg_init)
    best_seq, improved_seq = [], []
    for _ in range(cfg.n_iters):
        ks, Ks = p["backward"](xs, us, args, reg)
        xs_c, us_c, c_c = jax.vmap(lambda a: p["forward"](xs, us, ks, Ks, args, a))(alphas)
        c_c = jnp.where(jnp.isnan(c_c), jnp.inf, c_c)
        best = jnp.argmin(c_c)
        c_best = c_c[best]
        improved = c_best < cost
        xs = jnp.where(improved, xs_c[best], xs)
        us = jnp.where(improved, us_c[best], us)
        cost = jnp.where(improved, c_best, cost)
        reg = jnp.where(improved, jnp.maximum(reg * 0.5, cfg.reg_min),
                        jnp.minimum(reg * 10.0, cfg.reg_max))
        best_seq.append(int(best))
        improved_seq.append(bool(improved))
    return np.array(best_seq), np.array(improved_seq), np.asarray(us), float(cost)


def _tie_pair(want, make, dx0):
    """float32 (dx, dy) near (dx0, sqrt(want^2... )) with make(dx, dy) ==
    float32(want) exactly (a hinge's kink): dx steps by ulps from dx0, dy is
    searched around the value that closes the gap."""
    f32 = np.float32
    want = f32(want)
    dx = f32(dx0)
    for _ in range(400):
        for dy in (f32(np.sqrt(max(float(want) ** 2 - float(dx) ** 2, 0.0))),
                   f32(np.sqrt(max(float(want) - float(dx) ** 2, 0.0)))):
            for _ in range(64):
                got = make(dx, dy)
                if got == want:
                    return dx, dy
                dy = np.nextafter(dy, f32(np.inf) if got < want else f32(0))
        dx = np.nextafter(dx, f32(np.inf))
    raise AssertionError(f"no float32 tie point for {want}")


def record_mpc() -> dict:
    """torch_mpc.npz, the MPC's JAX side (op by op, some pieces jitted):
      - "gate/pass/...": one backward pass (`ks`, `Ks`) and one forward
        pass per step size (`xs`, `us`, `cost`, (S, E, ...)) of the JAX
        solver for `gate_cost` at A = 2, H = MPC_H, from equal (xs, us,
        args): `us` drawn from RandomState(0) (`_mpc_inputs`), `xs` their
        rollout, reg 1e-2; and the linearization (`fx`, `fu`, `lx`, `lu`,
        `lxx`, `luu`, `lux`) at those knots;
      - "<task>/solve/...": a whole solve of `_mpc_problem(task)` at
        MPC_ENVS envs (inputs from RandomState(1)): `xs`, `us`, `cost`,
        `cost_trace`, and per env the step-size index each iteration chose
        and whether it improved (`best`, `improved`; `_alpha_trace`), for
        gate, pushbox and waypoint;
      - "kink/<cost>/...": a stage cost, its gradient and Hessian in (x, u)
        at a point on a hinge's kink: "sep", two robots exactly d_min apart
        under gate_cost; "heading", a robot exactly 2 m from its waypoint
        under waypoint_cost.
    """
    import jax.numpy as jnp

    from mqe_tpu.mpc import costs as C
    from mqe_tpu.mpc.ilqr import make_ilqr

    rec = {}
    dyn, stage, final, cfg = _mpc_problem("gate")
    solve = make_ilqr(dyn, stage, final, cfg)
    p = _ilqr_parts(solve)
    x0, u0, args = _mpc_inputs("gate", np.random.RandomState(0))
    us = jnp.clip(jnp.asarray(u0), jnp.asarray(cfg.u_min), jnp.asarray(cfg.u_max))
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    xs = jax.vmap(p["rollout"])(jnp.asarray(x0), us, jargs)
    reg = jnp.full((MPC_ENVS,), 1e-2)
    ks, Ks = jax.vmap(p["backward"])(xs, us, jargs, reg)
    lin = jax.vmap(_ilqr_parts(p["backward"])["linearize"])(xs, us, jargs)
    fw = [jax.vmap(lambda x_, u_, k_, K_, a_: p["forward"](x_, u_, k_, K_, a_, alpha))(
        xs, us, ks, Ks, jargs) for alpha in p["alphas"]]
    rec.update({"gate/pass/xs": np.asarray(xs), "gate/pass/us": np.asarray(us),
                "gate/pass/reg": np.asarray(reg), "gate/pass/ks": np.asarray(ks),
                "gate/pass/Ks": np.asarray(Ks)})
    rec.update({f"gate/pass/args/{k}": v for k, v in args.items()})
    for name, v in zip(("fx", "fu", "lx", "lu", "lxx", "luu", "lux"), lin):
        rec[f"gate/pass/{name}"] = np.asarray(v)
    for i, name in enumerate(("fw_xs", "fw_us", "fw_cost")):
        rec[f"gate/pass/{name}"] = np.stack([np.asarray(f[i]) for f in fw])

    for task in ("gate", "pushbox", "waypoint"):
        dyn, stage, final, cfg = _mpc_problem(task)
        solve = make_ilqr(dyn, stage, final, cfg)
        x0, u0, args = _mpc_inputs(task, np.random.RandomState(1))
        jargs = {k: jnp.asarray(v) for k, v in args.items()}
        sol = jax.jit(jax.vmap(solve))(jnp.asarray(x0), jnp.asarray(u0), jargs)
        traces = [_alpha_trace(solve, jnp.asarray(x0[e]), jnp.asarray(u0[e]),
                               {k: v[e] for k, v in jargs.items()}) for e in range(MPC_ENVS)]
        for e, (_, _, us_e, c_e) in enumerate(traces):
            assert np.allclose(us_e, np.asarray(sol.us[e]), atol=1e-5), "the iteration replay"
            assert np.isclose(c_e, float(sol.cost[e]), rtol=1e-5), "the iteration replay"
        pre = f"{task}/solve"
        rec.update({f"{pre}/x0": x0, f"{pre}/u_init": u0, f"{pre}/xs": np.asarray(sol.xs),
                    f"{pre}/us": np.asarray(sol.us), f"{pre}/cost": np.asarray(sol.cost),
                    f"{pre}/cost_trace": np.asarray(sol.cost_trace),
                    f"{pre}/best": np.stack([t[0] for t in traces]),
                    f"{pre}/improved": np.stack([t[1] for t in traces])})
        rec.update({f"{pre}/args/{k}": v for k, v in args.items()})
        print(task, "costs", np.asarray(sol.cost), "best", rec[f"{pre}/best"].tolist(),
              "improved", rec[f"{pre}/improved"].tolist())

    # the hinges' kinks: gate_cost's separation (d_min 0.45 under gate_cost:
    # d2 == 0.45 ** 2 in float32) and waypoint_cost's heading term (dist ==
    # 2.0); robot 1 / the robot at the origin, so the differences are exact
    f32 = np.float32
    sq = lambda a, b: f32(f32(a * a) + f32(b * b))  # noqa: E731
    dx, dy = _tie_pair(0.45 ** 2, sq, 0.3)
    assert f32(0.45 ** 2) - sq(dx, dy) == 0
    x_sep = np.zeros(12, f32)
    x_sep[[0, 1]] = [dx, dy]
    hx, hy = _tie_pair(2.0, lambda a, b: f32(np.sqrt(f32(sq(a, b) + f32(1e-6)))), 1.9)
    x_head = np.array([0.0, 0.0, 0.3, 0.1, 0.0, 0.05], f32)
    kink = {
        "sep": (C.gate_cost(2)[0], x_sep, {"gate": np.array([3.8, 0.1], f32),
                                           "goal_x": np.array(6.1, f32)}),
        "heading": (C.waypoint_cost(1)[0], x_head, {"targets": np.array([[hx, hy]], f32)}),
    }
    for name, (st, x, a) in kink.items():
        n = x.shape[0]
        u = (0.1 * np.arange(n // 2, dtype=f32) - 0.2).astype(f32)
        z = jnp.concatenate([jnp.asarray(x), jnp.asarray(u)])
        ja = {k: jnp.asarray(v) for k, v in a.items()}
        lz = lambda z_: st(z_[:n], z_[n:], 0, ja)  # noqa: E731
        rec.update({f"kink/{name}/x": x, f"kink/{name}/u": u,
                    f"kink/{name}/value": np.asarray(lz(z)),
                    f"kink/{name}/grad": np.asarray(jax.grad(lz)(z)),
                    f"kink/{name}/hessian": np.asarray(jax.hessian(lz)(z))})
        rec.update({f"kink/{name}/args/{k}": v for k, v in a.items()})
    return rec


# ---------------------------------------------------------------------------
# the AoS reference physics (torch_dynamics.npz, torch_aos_substep.npz,
# torch_go1gate_aos_step.npz)
# ---------------------------------------------------------------------------

# body models of the dynamics record: (asset, root_free), B trees each
DYN_MODELS = (("go1", True), ("box", True), ("seesaw", False), ("rotation_door", False),
              ("cylinder", True))
DYN_B = 6


def _dyn_inputs(m, rng):
    """A batch of DYN_B random states, torques and world wrenches of model m."""
    B = DYN_B
    qt = rng.randn(B, 4) * 0.3 + np.array([0, 0, 0, 1.0])
    lo, hi = m.q_lower, m.q_upper
    mid = np.where(np.isfinite(lo) & np.isfinite(hi), np.clip((lo + hi) / 2, -1.0, 1.0), 0.0)
    d = dict(pos=rng.randn(B, 3) * 0.2 + np.array([0, 0, 0.4]),
             quat=qt / np.linalg.norm(qt, axis=1, keepdims=True),
             lin_vel=rng.randn(B, 3) * 0.5, ang_vel=rng.randn(B, 3) * 0.5,
             q=mid + rng.randn(B, m.nq) * 0.3, qd=rng.randn(B, m.nq) * 1.0,
             tau=rng.randn(B, m.nq) * 3.0, f_ext=rng.randn(B, m.nb, 6) * 5.0,
             payload=rng.rand(B) * 2.0, com_shift=rng.randn(B, 3) * 0.02)
    return {k: v.astype(np.float32) for k, v in d.items()}


def record_dynamics() -> dict:
    """The JAX AoS dynamics on random inputs, op by op under vmap:
    "<model>/in/<name>" the inputs, "<model>/fd/<out>" `forward_dynamics`
    (omega_dot_w, a_lin_w, qdd, Rw, pw, vw) with the trunk's spatial
    inertia changed by payload and com_shift as `scene._spatial_inertias`
    does, "<model>/star/<out>" `forward_dynamics_star` where `star_layout`
    accepts the model, "<model>/momentum/{ang,lin}" `total_momentum`,
    "<model>/int/<field>" `integrate` of the state by the fd result at
    dt 0.005 (the state's q pushed past the joint limits in half the rows,
    so the clamps act); "solve/{A,b,x}" `solve_spd6` on SPD matrices and on
    matrices that are not positive definite (rows 4-7: a zero, a negative
    and a rank-deficient pivot), "gravity/..." `scene._gravity_wrench` and
    "spheres/..." `scene._sphere_world` and `_accumulate_wrench` of go1."""
    import jax.numpy as jnp

    from mqe_tpu.physics import dynamics, integrator, spatial
    from mqe_tpu.physics import scene as JS
    from mqe_tpu.physics.model import load_model
    from mqe_tpu.physics.star_dynamics import forward_dynamics_star, star_layout

    rng = np.random.RandomState(21)
    rec = {}
    for name, root_free in DYN_MODELS:
        m = load_model(name, root_free=root_free)
        d = _dyn_inputs(m, rng)
        j = {k: jnp.asarray(v) for k, v in d.items()}
        Isp = jax.vmap(lambda p, c: JS._spatial_inertias(m, p, c))(j["payload"], j["com_shift"])
        args = (j["pos"], j["quat"], j["lin_vel"], j["ang_vel"], j["q"], j["qd"], j["tau"],
                j["f_ext"])
        rec.update({f"{name}/in/{k}": v for k, v in d.items()})
        fds = {"fd": dynamics.forward_dynamics}
        if star_layout(m) is not None:
            fds["star"] = forward_dynamics_star
        for tag, fd in fds.items():
            wd, ad, qdd, (Rw, pw, vw) = jax.vmap(lambda I, *a: fd(m, I, *a))(Isp, *args)
            for k, v in dict(wd=wd, ad=ad, qdd=qdd, Rw=Rw, pw=pw, vw=vw).items():
                rec[f"{name}/{tag}/{k}"] = np.asarray(v)
        h_ang, h_lin = jax.vmap(lambda I, *a: dynamics.total_momentum(m, I, *a))(
            Isp, *args[:6])
        rec[f"{name}/momentum/ang"], rec[f"{name}/momentum/lin"] = (np.asarray(h_ang),
                                                                   np.asarray(h_lin))
        past = np.where(rng.rand(DYN_B, m.nq) < 0.5, m.q_lower - 0.05, m.q_upper + 0.05)
        q_int = np.where((np.arange(DYN_B)[:, None] % 2 == 1) & (np.abs(past) < 20.0), past,
                         d["q"]).astype(np.float32)
        rec[f"{name}/in/q_int"] = q_int
        out = jax.vmap(lambda *a: integrator.integrate(m, *a, 0.005))(
            j["pos"], j["quat"], j["lin_vel"], j["ang_vel"], jnp.asarray(q_int), j["qd"],
            jnp.asarray(rec[f"{name}/fd/wd"]), jnp.asarray(rec[f"{name}/fd/ad"]),
            jnp.asarray(rec[f"{name}/fd/qdd"]))
        for k, v in zip(ACTOR_FIELDS, out):
            rec[f"{name}/int/{k}"] = np.asarray(v)
    # solve_spd6: SPD, then a zero, a negative and a rank-deficient pivot
    G = rng.randn(8, 6, 6)
    A = G @ np.swapaxes(G, 1, 2) + 0.5 * np.eye(6)
    A[4, 0, :] = A[4, :, 0] = 0.0
    A[5, 2, 2] = -3.0
    v = rng.randn(6)
    A[6] = np.outer(v, v) + np.diag([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
    A[7] = -np.eye(6)
    b = rng.randn(8, 6)
    A, b = A.astype(np.float32), b.astype(np.float32)
    rec.update({"solve/A": A, "solve/b": b,
                "solve/x": np.asarray(spatial.solve_spd6(jnp.asarray(A), jnp.asarray(b)))})
    # the scene's per-tree helpers on go1 (FK of the first model's inputs)
    m = load_model("go1")
    d = {k[len("go1/in/"):]: v for k, v in rec.items() if k.startswith("go1/in/")}
    Rw, pw, vw = (jnp.asarray(rec[f"go1/fd/{k}"]) for k in ("Rw", "pw", "vw"))
    sx, sv = jax.vmap(lambda R, p, w: JS._sphere_world(m, R, p, w))(Rw, pw, vw)
    f = rng.randn(*sx.shape).astype(np.float32) * 5.0
    wr = jax.vmap(lambda p, x, ff: JS._accumulate_wrench(m, p, x, ff))(pw, sx, jnp.asarray(f))
    grav = jax.vmap(lambda R, p, c: JS._gravity_wrench(m, R, p, c))(
        Rw, jnp.asarray(d["payload"]), jnp.asarray(d["com_shift"]))
    rec.update({"spheres/x": np.asarray(sx), "spheres/v": np.asarray(sv), "spheres/force": f,
                "spheres/wrench": np.asarray(wr), "gravity/wrench": np.asarray(grav)})
    return rec


def _gate_state(env, rng):
    """go1gate: env 0's robot 0 backed into the first wall box, env 1's two
    robots side by side with their coarse spheres overlapping."""
    ag = _agents(env, rng)
    box = np.asarray(env.env_boxes)[0, 0]                   # center(3), half(3), valid
    ag["pos"][0, 0] = [box[0] + box[3] + 0.15, box[1] - 0.5, 0.30]
    ag["pos"][1, 1, :2] = ag["pos"][1, 0, :2] + np.array([0.05, 0.15])
    return ag, _npcs(np.zeros((NUM_ENVS, 0, 3)), np.zeros((NUM_ENVS, 0, 0)),
                     np.zeros((NUM_ENVS, 0, 0)), rng)


def _sheep_state(env, rng):
    """go1sheep-hard: the flock where the env puts it, sheep 1 pressed into
    sheep 0 and robot 0 into sheep 2 (NPC pairs and robot-NPC contact)."""
    ag = _agents(env, rng)
    N = env.scene.num_npcs
    pos = (np.asarray(env.npc_init)[None, :, :3]
           + np.asarray(env.env_origins)[:, None] * [1, 1, 0]).astype(np.float64)
    pos[..., 2] = 0.19
    pos[:, 1] = pos[:, 0] + np.array([0.3, 0.05, 0.0])
    ag["pos"][:, 0] = pos[:, 2] + np.array([-0.55, 0.0, 0.11])
    z = np.zeros((NUM_ENVS, N, 0))
    return ag, _npcs(pos, z, z, rng)


AOS_CASES = {"gate": ("go1gate", "", _gate_state),
             "pushbox": ("go1pushbox", "", _pushbox_state),
             "seesaw": ("go1seesaw", "", _seesaw_state),
             "wrestling-ring": ("go1wrestling", "", _wrestling_state),
             "sheep-hard": ("go1sheep-hard", "", _sheep_state)}


def _aos_substep(jscene, env, jstate, tau, npc_tau, jdr, dt):
    """JAX's AoS substep vmapped over the env axis, each env on its own
    boxes and static geoms (go1_env.py's `use_soa=False` branch)."""
    from mqe_tpu.physics import scene as JS

    def one(phys, tau_e, npc_tau_e, dr_e, boxes_e, sg_e):
        t = JS.Terrain(height=env.hf, origin=env.hf_origin, scale=env.hf_scale,
                       boxes=boxes_e, static_geoms=sg_e)
        return JS.substep(jscene, t, phys, tau_e, npc_tau_e, dr_e, dt)

    return jax.vmap(one)(jstate, tau, npc_tau, jdr, env.env_boxes, env.static_geoms)


def record_aos_substep() -> dict:
    """torch_npc_substep.npz's record for `AOS_CASES`, by JAX's AoS
    `scene.substep` under vmap (op by op, no jit)."""
    return record_npc_substep(tuple(AOS_CASES), AOS_CASES, substep=_aos_substep)


def record_aos_step() -> dict:
    """One go1gate control step with `use_soa=False` from the "in-contact"
    start of torch_go1gate_step.npz (the same warm-up, then a wrapper whose
    scene is the AoS one traces its step)."""
    import dataclasses

    from mqe_tpu.envs.registry import make_mqe_env

    rec = record("go1gate", ("in-contact",))
    wrap, _ = make_mqe_env("go1gate", num_envs=NUM_ENVS, seed=0)
    object.__setattr__(wrap.env, "scene", dataclasses.replace(wrap.env.scene, use_soa=False))
    ts0 = _unflat_like(wrap.reset(jax.random.PRNGKey(0))[0], rec, "in-contact/start")
    ts1, obs, rew, done, _ = wrap.step(ts0, rec["in-contact/actions"], jax.random.PRNGKey(7))
    out = {k: v for k, v in rec.items() if k.startswith("in-contact/start")
           or k == "in-contact/actions"}
    out.update(_flat("in-contact/out", ts1))
    out.update({"in-contact/obs": np.asarray(obs), "in-contact/reward": np.asarray(rew),
                "in-contact/done": np.asarray(done)})
    return out


def _unflat_like(tree, rec, prefix):
    """`tree` with its leaves replaced by rec's "<prefix>/<path>" arrays."""
    import jax.numpy as jnp

    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, _ in paths:
        names = [str(getattr(k, "name", getattr(k, "key", k))) for k in path]
        leaves.append(jnp.asarray(rec["/".join([prefix] + names)]))
    return jax.tree_util.tree_unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# the JAX package's trajectory goldens, their starts and draws
# (torch_golden_traj.npz)
# ---------------------------------------------------------------------------

def _drop_env():
    from mqe_tpu.envs.go1_env import Go1Env
    from mqe_tpu.envs.tasks import Go1PlaneCfg

    class DropCfg(Go1PlaneCfg):
        class init_state(Go1PlaneCfg.init_state):
            pos = [0.0, 0.0, 0.62]

        class domain_rand(Go1PlaneCfg.domain_rand):
            init_base_pos_range = dict(x=[0.0, 0.0], y=[0.0, 0.0])
            init_base_vel_range = [0.0, 0.0]
            init_dof_pos_ratio_range = [1.0, 1.0]

        class termination(Go1PlaneCfg.termination):
            termination_terms = []

    return Go1Env(DropCfg, num_envs=2, seed=0)


# name: (task or "drop", steps, vx, envs), as tests/test_golden_traj.py runs them
TRAJS = {"drop": ("drop", 60, 0.0, 2), "walk": ("go1plane", 100, 0.5, 1),
         "push": ("go1pushbox", 80, 0.5, 2)}


def _step_draws(env, key, E, A, N):
    """The draws JAX's `_step_pre`/`_step_finish` take from a step key, by
    the names the port takes them under (not "fresh": see below)."""
    k_npc, k_push, k_reset, k_lv = jax.random.split(key, 4)
    out = {}
    if env.npc_behavior == "sheep":
        out["npc_noise"] = np.asarray(jax.random.normal(k_npc, (E, N, 3)))
    if env.cfg.domain_rand.push_robots:
        mv = env.cfg.domain_rand.max_push_vel_xy
        out["push_vel"] = np.asarray(jax.random.uniform(k_push, (E, A, 2), minval=-mv,
                                                        maxval=mv))
    if env.curriculum:
        out["curr_level"] = np.asarray(jax.random.randint(k_lv, (E,), 0, env.num_levels))
    return out, k_reset


def record_golden_traj() -> dict:
    """For each of `TRAJS`, what tests/test_golden_traj.py runs: "<name>/start/..."
    the reset state of PRNGKey(42) (the wrapper's TaskState, or the env's
    EnvState for "drop"); per step t the draws the step takes
    ("<name>/draw/<t>/<draw>"), the step's done flags ("<name>/done", (T, E)),
    and for a step in which an env is done the reset state it takes
    ("<name>/fresh/<t>/..."). The step keys are split from PRNGKey(1) for
    "drop" and from PRNGKey(42) for the others, as the goldens were."""
    import jax.numpy as jnp

    from mqe_tpu.envs import make_mqe_env

    rec = {}
    for name, (task, steps, vx, E) in TRAJS.items():
        if task == "drop":
            env = _drop_env()
            ts = env._reset_all(jax.random.PRNGKey(42))
            key = jax.random.PRNGKey(1)
            A = env.num_agents
            cmds = jnp.zeros((E, A, 3))
            step = jax.jit(lambda s, k: env._step(s, cmds, k)[::2])
        else:
            wrap, _ = make_mqe_env(task, num_envs=E, seed=0)
            key = jax.random.PRNGKey(42)
            ts, _ = wrap.reset(key)
            env = wrap.env
            A = getattr(wrap, "controlled_agents", wrap.num_agents)
            acts = jnp.zeros((E, A, 3)).at[..., 0].set(vx)
            step = jax.jit(lambda s, k: wrap._step_impl(s, acts, k)[::3])
        rec.update(_flat(f"{name}/start", ts))
        dones = []
        for t in range(steps):
            key, k = jax.random.split(key)
            draws, k_reset = _step_draws(env, k, E, env.num_agents, env.num_npcs)
            rec.update({f"{name}/draw/{t}/{d}": v for d, v in draws.items()})
            ts, done = step(ts, k)
            dones.append(np.asarray(done))
            if dones[-1].any():
                rec.update(_flat(f"{name}/fresh/{t}", env._reset_all(k_reset)))
        rec[f"{name}/done"] = np.stack(dones)
    return rec


# JAX's envelope of a step (torch_golden_steps.npz): its jitted step from the
# scan's state with the robots' qd and ang_vel scaled by (1 + REL * N(0, 1)),
# K draws a step. REL is the size of the port's own rounding stage by stage:
# fed JAX's input of each stage of the drop's landing step
# (tools/diag_drop_golden.py --stages), the port's locomotion action parts
# from JAX's by 8.9e-7 relative, each actuator-net torque by 8.1e-8 at most,
# each `_physics` (two scene substeps) by 6.8e-6 at most in qd and 1.1e-6 in
# ang_vel.
ENVELOPE_DRAWS, ENVELOPE_REL = 16, 1e-6


def _golden_run(name):
    """The env, start state, step key and step function of the golden `name`
    (`TRAJS`), as tools/make_goldens.py runs it, with `fn(state, key)`
    returning (state, done) and `phys(state)` its PhysState."""
    import jax.numpy as jnp

    from mqe_tpu.envs import make_mqe_env

    task, _, vx, E = TRAJS[name]
    if task == "drop":
        env = _drop_env()
        cmds = jnp.zeros((E, env.num_agents, 3))
        return (env, env._reset_all(jax.random.PRNGKey(42)), jax.random.PRNGKey(1),
                lambda s, k: env._step(s, cmds, k)[::2], lambda s: s.phys)
    wrap, _ = make_mqe_env(task, num_envs=E, seed=0)
    A = getattr(wrap, "controlled_agents", wrap.num_agents)
    acts = jnp.zeros((E, A, 3)).at[..., 0].set(vx)
    key = jax.random.PRNGKey(42)
    return (wrap.env, wrap.reset(key)[0], key,
            lambda s, k: wrap._step_impl(s, acts, k)[::3], lambda s: s.env.phys)


def _step_fields(phys):
    out = {f: np.asarray(getattr(phys.agents, f)) for f in ACTOR_FIELDS}
    if phys.npcs.pos.shape[-2]:
        out["npc_pos"] = np.asarray(phys.npcs.pos)
    return out


def _nudged(state, phys_of, rng):
    """`state` with the robots' qd and ang_vel scaled by (1 + REL * N(0, 1))."""
    ag = phys_of(state).agents
    scale = lambda x: x * (1.0 + ENVELOPE_REL * rng.standard_normal(x.shape)  # noqa: E731
                           ).astype(np.float32)
    ag = ag.replace(qd=scale(ag.qd), ang_vel=scale(ag.ang_vel))
    if hasattr(state, "phys"):
        return state.replace(phys=state.phys.replace(agents=ag))
    return state.replace(env=state.env.replace(phys=state.env.phys.replace(agents=ag)))


def record_golden_steps() -> dict:
    """For each of `TRAJS`, the golden's `lax.scan` state by state, and JAX's
    own spread about each of its steps (tests/test_torch_golden_steps.py).
    The scan is tools/make_goldens.py's (same starts and step keys as
    `record_golden_traj`), its body returning the whole state, whose robots
    are checked equal to the golden's pos, quat and q at every step. Per run
    `name` of T steps:
      - "<name>/state/...": (T, ...) the states the steps leave from (the
        start, then the scan's first T - 1; the EnvState for "drop", the
        TaskState for the others);
      - "<name>/after/<field>": (T, E, A, ...) the robots' `ACTOR_FIELDS`
        after step t, and "npc_pos" with NPCs;
      - "<name>/envelope/<field>": (T,) the largest difference from "after"
        of JAX's jitted step from state t nudged (`_nudged`) over
        ENVELOPE_DRAWS draws of np.random.default_rng(0);
      - "<name>/jit/<field>": (T,) the same of JAX's jitted step from state t
        not nudged: nearly the scan's own arithmetic, so no measure of
        rounding (tools/diag_drop_golden.py prints it as such);
      - "<name>/draw/<t>/<draw>" and "<name>/done" as in `record_golden_traj`.
    """
    import jax.numpy as jnp

    rec = {"envelope_draws": np.int64(ENVELOPE_DRAWS), "envelope_rel": np.float64(ENVELOPE_REL)}
    for name, (_, steps, _, E) in TRAJS.items():
        env, start, key, fn, phys_of = _golden_run(name)

        def body(carry, _):
            s, k0 = carry
            k0, k = jax.random.split(k0)
            s, done = fn(s, k)
            return (s, k0), (s, done)

        _, (scan, dones) = jax.lax.scan(body, (start, key), None, length=steps)
        golden = dict(np.load(os.path.join(GOLDENS, f"{name}.npz")))
        after = _step_fields(phys_of(scan))
        for f in ("pos", "quat", "q"):
            assert np.array_equal(after[f], golden[f]), f"{name} {f}: the scan is not the golden's"
        if "npc_pos" in golden:
            assert np.array_equal(after["npc_pos"], golden["npc_pos"]), name
        rec.update({f"{name}/after/{f}": v for f, v in after.items()})
        rec[f"{name}/done"] = np.asarray(dones)
        assert not rec[f"{name}/done"].any(), f"{name}: an env reset in the golden's run"
        before = jax.tree.map(lambda s0, s: jnp.concatenate([s0[None], s[:-1]]), start, scan)
        rec.update(_flat(f"{name}/state", before))
        jstep = jax.jit(lambda s, k: fn(s, k)[0])
        rng = np.random.default_rng(0)
        env_of = {f: np.zeros(steps) for f in after}
        jit_of = {f: np.zeros(steps) for f in after}
        for t in range(steps):
            key, k = jax.random.split(key)
            draws, _ = _step_draws(env, k, E, env.num_agents, env.num_npcs)
            rec.update({f"{name}/draw/{t}/{d}": v for d, v in draws.items()})
            state = jax.tree.map(lambda x: x[t], before)
            for f, v in _step_fields(phys_of(jstep(state, k))).items():
                jit_of[f][t] = float(np.abs(v - after[f][t]).max())
            for _ in range(ENVELOPE_DRAWS):
                out = _step_fields(phys_of(jstep(_nudged(state, phys_of, rng), k)))
                for f, v in out.items():
                    env_of[f][t] = max(env_of[f][t], float(np.abs(v - after[f][t]).max()))
        rec.update({f"{name}/envelope/{f}": v for f, v in env_of.items()})
        rec.update({f"{name}/jit/{f}": v for f, v in jit_of.items()})
        print(f"{name}: JAX's envelope, largest (step): " + ", ".join(
            f"{f} {v.max():.3e} ({int(v.argmax())})" for f, v in env_of.items()), flush=True)
    return rec


FILES = {
    "torch_go1gate_step.npz": partial(record, "go1gate", ("post-reset", "in-contact")),
    "torch_go1gate_reset_step.npz": partial(record, "go1gate", ("reset-step",)),
    "torch_go1plane_step.npz": partial(record, "go1plane", ("post-reset", "in-contact")),
    "torch_go1pushbox_step.npz": partial(record, "go1pushbox",
                                         ("post-reset", "in-contact", "reset-step")),
    "torch_go1seesaw_step.npz": partial(record, "go1seesaw", ("post-reset", "in-contact")),
    "torch_npc_substep.npz": record_npc_substep,
    "torch_go1football-defender_step.npz": partial(record, "go1football-defender",
                                                   ("post-reset", "in-contact")),
    "torch_go1football-1vs1_step.npz": partial(record, "go1football-1vs1",
                                               ("post-reset", "in-contact")),
    "torch_go1football-2vs2_step.npz": partial(record, "go1football-2vs2",
                                               ("post-reset", "in-contact")),
    "torch_go1tug_step.npz": partial(record, "go1tug", ("post-reset", "in-contact", "selfplay")),
    "torch_go1wrestling_step.npz": partial(record, "go1wrestling",
                                           ("post-reset", "in-contact", "selfplay")),
    "torch_go1revolvingdoor_step.npz": partial(record, "go1revolvingdoor",
                                               ("post-reset", "in-contact", "selfplay")),
    "torch_go1bridge_step.npz": partial(record, "go1bridge",
                                        ("post-reset", "in-contact", "selfplay")),
    "torch_go1door_step.npz": partial(record, "go1door", ("post-reset", "in-contact")),
    "torch_go1sheep-easy_step.npz": partial(record, "go1sheep-easy",
                                            ("post-reset", "in-contact")),
    "torch_go1sheep-hard_step.npz": partial(record, "go1sheep-hard",
                                            ("post-reset", "in-contact", "reset-step")),
    "torch_static_substep.npz": partial(record_npc_substep, tuple(STATIC_CASES), STATIC_CASES),
    "torch_learn.npz": record_learn,
    "torch_go1gate_ppo_update.npz": record_ppo_update,
    "torch_locomotion_step.npz": record_locomotion,
    "torch_policy_step.npz": record_policy_backend,
    "torch_go1gate_events_step.npz": record_events,
    "torch_locomotion_ppo_update.npz": record_loco_ppo_update,
    "torch_terrain.npz": record_terrain,
    "torch_camera.npz": record_camera,
    "torch_mpc.npz": record_mpc,
    "torch_dynamics.npz": record_dynamics,
    "torch_aos_substep.npz": record_aos_substep,
    "torch_go1gate_aos_step.npz": record_aos_step,
    "torch_golden_traj.npz": record_golden_traj,
    "torch_golden_steps.npz": record_golden_steps,
}


def main(names):
    for name in names or [n for n in FILES if not os.path.exists(os.path.join(GOLDENS, n))]:
        name = os.path.basename(name)  # a FILE may be given by its path in the repo
        rec = FILES[name]()
        out = os.path.normpath(os.path.join(GOLDENS, name))
        np.savez_compressed(out, **rec)
        dones = {k: v.tolist() for k, v in rec.items() if k.endswith("/done")}
        print(f"wrote {out}: {len(rec)} arrays, {os.path.getsize(out)} bytes; done {dones}")


if __name__ == "__main__":
    main(sys.argv[1:])
