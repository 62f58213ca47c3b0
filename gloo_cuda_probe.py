"""Which ``torch.distributed`` collectives gloo takes on CUDA tensors, on
4 ranks that share one card (``kornia_tpu_torch.parallel.mesh.spawn``).

    python3 gloo_cuda_probe.py

Each collective runs in its own spawn, so that one that kills its ranks
(gloo's point-to-point hands the device pointer to its socket and aborts
the process) does not hide the rest. Prints one line a collective: ok,
WRONG values, or FAIL with the ranks' report, and the spawn's seconds.
"""

import time

import torch
import torch.distributed as dist

from kornia_tpu_torch.parallel import mesh as tm

RANKS = 4


def _ones(mesh, shape=(8,), dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=mesh.device)


def all_reduce(mesh):
    t = _ones(mesh)
    dist.all_reduce(t)
    return float(t[0]) == mesh.size


def all_reduce_0dim(mesh):
    t = _ones(mesh, ())
    dist.all_reduce(t)
    return float(t) == mesh.size


def all_gather(mesh, dtype=torch.float32):
    out = torch.empty(mesh.size, 8, dtype=dtype, device=mesh.device)
    dist.all_gather(list(out.unbind(0)), _ones(mesh, dtype=dtype) * mesh.rank)
    return out[:, 0].tolist() == list(range(mesh.size))


def all_gather_u8(mesh):
    return all_gather(mesh, torch.uint8)


def broadcast(mesh):
    t = _ones(mesh) * mesh.rank
    dist.broadcast(t, 0)
    return float(t[0]) == 0


def all_to_all_even(mesh):
    out = torch.empty(mesh.size * 2, 3, device=mesh.device)
    dist.all_to_all_single(out, _ones(mesh, (mesh.size * 2, 3)) * mesh.rank)
    return out[::2, 0].tolist() == list(range(mesh.size))


def all_to_all_uneven(mesh):
    r, d = mesh.rank, mesh.size
    send = [2 if t == (r + 1) % d else 0 for t in range(d)]
    recv = [2 if s == (r - 1) % d else 0 for s in range(d)]
    out = torch.empty(2, 3, device=mesh.device)
    dist.all_to_all_single(out, _ones(mesh, (2, 3)) * r, recv, send)
    return float(out[0, 0]) == (r - 1) % d


def batch_isend_irecv(mesh):
    r, d = mesh.rank, mesh.size
    got = torch.empty(3, device=mesh.device)
    ops = [dist.P2POp(dist.isend, _ones(mesh, (3,)) * r, (r + 1) % d),
           dist.P2POp(dist.irecv, got, (r - 1) % d)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return float(got[0]) == (r - 1) % d


def main():
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for fn in (all_reduce, all_reduce_0dim, all_gather, all_gather_u8,
               broadcast, all_to_all_even, all_to_all_uneven,
               batch_isend_irecv):
        t0 = time.time()
        try:
            out = tm.spawn(fn, RANKS, devices=["cuda:0"] * RANKS, timeout=60)
            res = "ok" if all(out) else f"WRONG {out}"
        except (RuntimeError, TimeoutError) as e:
            res = "FAIL " + " ".join(str(e).split())[-300:]
        print(f"gloo, {RANKS} ranks on cuda:0, {fn.__name__}: {res} "
              f"({time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
