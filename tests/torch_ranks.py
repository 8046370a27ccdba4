"""Launch a Python script as N gloo ranks for the port's multi-process
tests, as torchrun would: one subprocess a rank with torchrun's variables
(RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), one torch
thread each. As torchrun's agent does, the launcher hosts the rendezvous
store itself (TORCHELASTIC_USE_AGENT_STORE: the ranks connect to it), on
a port it holds from the start, so that launches running side by side
cannot race for one. When one rank fails or the time runs out, every
rank is killed (a survivor would wait on the collective forever)."""
import os
import subprocess
import sys
import time
from pathlib import Path

import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent


def launch(script, nprocs, args=(), env=None, timeout=240, cwd=None):
    """Run `script` (a path) as `nprocs` ranks -> each rank's output, in
    rank order. Asserts that every rank exited 0."""
    store = dist.TCPStore('localhost', 0, nprocs, is_master=True,
                          wait_for_workers=False)
    port = store.port
    procs, logs = [], []
    for rank in range(nprocs):
        e = dict(os.environ, **(env or {}))
        e.update(RANK=str(rank), LOCAL_RANK=str(rank),
                 WORLD_SIZE=str(nprocs), MASTER_ADDR='localhost',
                 MASTER_PORT=str(port), TORCHELASTIC_USE_AGENT_STORE='True',
                 OMP_NUM_THREADS='1',
                 PYTHONPATH=os.pathsep.join(
                     [str(ROOT)] + [p for p in [os.environ.get(
                         'PYTHONPATH')] if p]))
        log = open(Path(cwd or script).parent / f'rank{rank}.log', 'w+')
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *map(str, args)], env=e,
            stdout=log, stderr=subprocess.STDOUT, cwd=cwd))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        del store
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    timed_out = time.monotonic() > deadline
    bad = [f'rank {rank} exited {p.returncode}:\n{out}'
           for rank, (p, out) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, ('timed out after %ds\n' % timeout if timed_out
                     else '') + '\n'.join(bad)
    return outs
