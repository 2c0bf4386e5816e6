"""What the ranks of ``tests/test_torch_port_parallel*.py`` run.

The tests start these functions in gloo ranks on the CPU through
``tao_amodal_torch.parallel.launch.run_ranks`` (rank 0 in the test's
process, the others spawned, a file store, one PyTorch thread a rank, a
timeout of their own) and hold what the ranks return against the JAX
package in the test process.  This
module imports numpy and the port only (no jax), so that a rank starts
quickly; every function takes ``rank`` first and returns picklable
numpy values.
"""

# Seconds a test's ranks may take, start-up and collectives included.
RANK_TIMEOUT = 240.0


def start(fn, world, *args):
    """``fn``'s results of ``world`` gloo ranks on the CPU."""
    from tao_amodal_torch.parallel.launch import run_ranks

    return run_ranks(fn, world, args=args, backend="gloo",
                     timeout=RANK_TIMEOUT, threads=1)


def _host(tree):
    import torch

    from tao_amodal_torch.parallel.mesh import tree_map

    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else x

    return tree_map(host, tree)


def streaming(rank, npz, clips, score_thr):
    """This rank's lane of ``clips [B, CLIPS, T, S, S, 3]`` through
    ``make_sharded_streaming``, the state threaded: ([outputs a clip],
    the final state's fields), and ``make_sharded_inference`` of the first
    clip."""
    import torch

    from tao_amodal_torch.parallel.mesh import make_mesh, shard_batch
    from tao_amodal_torch.pipeline import (
        make_sharded_inference,
        make_sharded_streaming,
    )
    from torch_port_fixtures import torch_pipeline

    mesh = make_mesh(device="cpu")
    pipe = torch_pipeline(npz)
    init_states, run = make_sharded_streaming(pipe, mesh,
                                              score_thr=score_thr)
    lane = shard_batch(mesh, torch.from_numpy(clips))
    states = init_states()
    outs = []
    for j in range(lane.shape[1]):
        out, states = run(lane[:, j], states)
        outs.append(_host(out))
    stateless = make_sharded_inference(pipe, mesh)(lane[:, 0])
    return outs, _host(states._asdict()), _host(stateless)


def dp_step(rank, npz, batch, draws, model, tp):
    """A step a draw of ``parallel.dp.make_train_step`` (SGD, JAX's
    ``make_optimizer``) over a ``(world / model, model)`` mesh on this
    rank's shard of ``batch``, draws[i] the global draws of step i (JAX's
    own); with ``tp`` the heads split first by ``place_tp``.  Returns
    each step's metrics and the leaves after them (flax names, this
    rank's shards) with their split dims."""
    import torch

    from tao_amodal_torch.parallel import dp
    from tao_amodal_torch.parallel.mesh import data_sharding, make_mesh
    from tao_amodal_torch.parallel.mesh import shard_batch, tree_map
    from tao_amodal_torch.parallel.tp import place_tp
    from tao_amodal_torch.train.optim import log_schedule, make_optimizer
    from tao_amodal_torch.train.step import detector_draws, detector_loss
    from torch_port_fixtures import torch_pipeline

    mesh = make_mesh(model=model, device="cpu")
    pipe = torch_pipeline(npz)
    sharding = place_tp(pipe, mesh) if tp else None
    step = dp.make_train_step(
        detector_loss, make_optimizer(log_schedule(1e-3, 1e-5, 10)), mesh,
        sharding, model=pipe, draws_fn=detector_draws)
    state = step.init_state()
    local = shard_batch(mesh, batch)
    metrics = []
    for d in draws:
        mine = tree_map(lambda x: torch.from_numpy(
            x[data_sharding(mesh, x.shape[0])]), d)
        state, m = step.run(state, local, mine)
        metrics.append({k: float(v) for k, v in m.items()})
    dims = [None if sharding is None else sharding.get(n)
            for n in step.names]
    leaves = [t.detach().numpy().copy() for t in step.leaves]
    return metrics, step.flax_names(), step.names, leaves, dims


def eval_step(rank, x):
    """``parallel.dp.make_eval_step`` of a two-metric function over a data
    mesh of every rank, on this rank's shard of ``x``."""
    import torch

    from tao_amodal_torch.parallel.dp import make_eval_step
    from tao_amodal_torch.parallel.mesh import make_mesh, shard_batch

    def metrics(model, batch):
        return {"mean": batch.mean(), "square": (batch * batch).mean()}

    mesh = make_mesh(device="cpu")
    out = make_eval_step(metrics, mesh)(None, shard_batch(mesh, x))
    return {k: float(v) for k, v in out.items() if torch.is_tensor(v)}


def tp_forward(rank, npz, clip, model):
    """The pipeline's outputs on ``clip`` with its heads split over a
    ``(world / model, model)`` mesh, the unsplit pipeline's, and the
    leaves' split dims."""
    import torch

    from tao_amodal_torch.parallel.mesh import make_mesh
    from tao_amodal_torch.parallel.tp import place_tp
    from torch_port_fixtures import torch_pipeline

    mesh = make_mesh(model=model, device="cpu")
    whole = torch_pipeline(npz)(torch.from_numpy(clip), score_thr=0.0)
    pipe = torch_pipeline(npz)
    shardings = place_tp(pipe, mesh)
    out = pipe(torch.from_numpy(clip), score_thr=0.0)
    return _host(out), _host(whole), shardings


def track_iou(rank, dt_boxes, dt_valid, gt_boxes, gt_valid):
    """``sharded_track_iou`` over a data mesh of every rank."""
    from tao_amodal_torch.parallel.cp import sharded_track_iou
    from tao_amodal_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    return sharded_track_iou(mesh, dt_boxes, dt_valid, gt_boxes,
                             gt_valid).numpy()


def device_eval(rank, gt, preds, cp_min_frames):
    """``DeviceTrackEval(mesh=...)``'s results over a data mesh of every
    rank, on the CPU, and how many videos took the frame-split IoU."""
    import copy

    from tao_amodal_torch.evaluation import DeviceTrackEval
    from tao_amodal_torch.parallel import cp
    from tao_amodal_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    calls = []
    real = cp.sharded_track_iou

    def counting(*args):
        calls.append(1)
        return real(*args)

    cp.sharded_track_iou = counting
    try:
        ev = DeviceTrackEval(copy.deepcopy(gt), copy.deepcopy(preds),
                             mesh=mesh, cp_min_frames=cp_min_frames,
                             device="cpu")
        ev.run()
    finally:
        cp.sharded_track_iou = real
    return ev.get_results(), len(calls)


def sampler(rank, num_samples, seed, epochs):
    """``ShardedSampler``'s indices of this rank (process index and
    count from the group) for each epoch, and ``host_shard_indices``."""
    from tao_amodal_torch.parallel.host import (
        ShardedSampler,
        host_shard_indices,
    )

    s = ShardedSampler(num_samples, seed=seed)
    return ([s.epoch_indices(e) for e in range(epochs)],
            host_shard_indices(8))


def mesh_layout(rank, data, model):
    """This rank's coordinates, and the ranks its data and model groups
    sum over (each group's all_reduce of ``2 ** rank``)."""
    import torch
    import torch.distributed as dist

    from tao_amodal_torch.parallel.mesh import all_reduce, make_mesh

    mesh = make_mesh(data=data, model=model, device="cpu")
    sums = []
    for group in (mesh.data_group, mesh.model_group):
        t = torch.tensor([2.0 ** dist.get_rank()], dtype=torch.float64)
        sums.append(int(all_reduce(t, group)[0]))
    return (mesh.shape, mesh.data_index, mesh.model_index, sums,
            str(mesh.device))


def scaled(context, item):
    """A ``PoolWithContext`` task: the item times the context."""
    return context * item


def on_device(context, device_id, item):
    """A ``FixedDevicePool`` task: (its device id, the worker's
    ``TAO_AMODAL_DEVICE``, the item times the context)."""
    import os

    return device_id, os.environ["TAO_AMODAL_DEVICE"], context * item
