"""The rank program of ``test_torch_pop_process_group.py``: one gloo rank
of a two-rank population mesh on the CPU. It imports only ``repro_torch``
(a spawned rank re-imports the module that holds its function)."""
import json
import os
import pickle


def _target(arrays):
    import torch

    from repro_torch.core import sru_experiment as TX
    from repro_torch.models import sru as TM

    cfg = TM.SRUModelConfig(**arrays["cfg"])

    def sets(pairs):
        return [(torch.from_numpy(f), torch.from_numpy(l)) for f, l in pairs]

    target = TX.TrainedSRU(cfg, TM.params_from_numpy(arrays["params"], "cpu"),
                           None, sets(arrays["val"]), sets(arrays["test"]),
                           dict(arrays["act_ranges"]), dict(arrays["wclips"]),
                           dict(arrays["wranges"]))
    target.baseline_val_error = target.val_error()
    return target


def _json(x):
    return json.loads(json.dumps(x))


def rank_main(rank, world, store, work):
    """Score the parent's populations in f32 and packed banks, run a
    silago search, then the same
    search with ``LoseDevices(at=2, keep=1)``; write what came out to
    ``work/rank{rank}.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import api as TA
    from repro_torch.core import faults as TF
    from repro_torch.distributed import pop_sharding as PS
    from repro_torch.launch.mesh import make_process_group_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(work, "arrays.pkl"), "rb") as f:
            arrays = pickle.load(f)
        mesh = make_process_group_mesh(device="cpu")
        pg = dict(mesh=mesh, partition="process_group")
        target = _target(arrays)
        out = {"shards": mesh.size, "physical_devices": mesh.physical_devices,
               "errors": [target.val_error_batch(allocs, bank_format=fmt,
                                                 **pg)
                          for fmt in ("f32", "packed")
                          for allocs in arrays["populations"]]}
        kw = arrays["search_kw"]
        out["front"] = _json(TA.SearchSession(
            target, "silago", share_memo=False, **pg).run(**kw).front_key())
        lossy = _target(arrays)
        ev = lossy.batched_evaluator(**pg)
        ev.faults = TF.FaultInjector([TF.LoseDevices(at=2, keep=1)])
        try:
            res = TA.SearchSession(lossy, "silago", share_memo=False,
                                   **pg).run(**kw)
            out["loss_front"] = _json(res.front_key())
        except PS.LeftMesh:
            out["loss_front"] = "left"
        out["fault_log"] = ev.fault_log
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
