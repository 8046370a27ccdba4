"""The serving cells: batch decode ('dec') and batch encode ('enc') in a
closed loop with `outstanding` requests in flight (the client dispatches
request k+1 before it waits on request k).

A decode's result is its images on the device with the device synchronized
up to them (an event recorded after the dispatch); an encode's is its
streams as bytes on the host (compress_batch_finish). A request's latency
runs from its dispatch to its result. The window opens at the first
dispatch and closes when the last request dispatched before `seconds`
have passed has its result: every request of the window is counted, and
the rate is all of their pixels over all of that time."""
import collections
import time
import traceback

import numpy as np
import torch

from harness import inputs, system
from harness.outcome import Outcome
from harness.roofline import least_seconds, reference_flops, trunk_calls
from harness.trace import Profiler, span


class Reservoir:
    """A seeded uniform sample of `size` of the window's results."""

    def __init__(self, size, rng):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.items[j] = item


def _lmbs(q, B):
    return None if q.lmb is None else [q.lmb] * B


def _compress(model, ims, lmbs):
    if lmbs is None:
        return model.compress_batch_finish(model.compress_batch_async(ims))
    return model.compress_batch_finish(
        model.compress_batch_async(ims, lmb=lmbs))


def _decode_dispatch(model, streams):
    out = model.decompress_batch_to_device(streams)
    ev = torch.cuda.Event() if out.is_cuda else None
    if ev is not None:
        ev.record()
    return out, ev


def _decode_wait(handle):
    out, ev = handle
    if ev is not None:
        ev.synchronize()
    return out


def closed_loop(dispatch, wait, order, seconds, outstanding, out, offer,
                max_requests=None):
    """Serve `order`'s requests with `outstanding` in flight until
    `seconds` have passed (or `max_requests` are dispatched), then wait for
    those in flight. Fills `out` (attempted, failed, completed, window_s,
    issue_s), hands each (request, result) to `offer`, returns every
    completed request's latency in seconds."""
    latencies, pending = [], collections.deque()
    k = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_done = t_start
    while True:
        while (len(pending) < outstanding and time.perf_counter() < deadline
               and (max_requests is None or k < max_requests)):
            q = next(order)
            t = time.perf_counter()
            try:
                with span('dispatch'):
                    h = dispatch(q)
            except Exception:                # a request the system refused
                out.failed += 1
                traceback.print_exc()
                k += 1
                continue
            out.issue_s.append(time.perf_counter() - t)
            pending.append((q, t, h))
            k += 1
        if not pending:
            break
        q, t, h = pending.popleft()
        try:
            with span('wait'):
                res = wait(h)
        except Exception:
            out.failed += 1
            traceback.print_exc()
            continue
        t_done = time.perf_counter()
        latencies.append(t_done - t)
        offer((q, res))
    out.window_s = t_done - t_start
    out.attempted = k
    out.completed = len(latencies)
    return latencies


def traced(dispatch, wait, order, n, outstanding, device, warm=2):
    """The traced sub-window, after the measured one: the profiler started,
    `warm` requests served one at a time (its own start-up, outside the
    traced spans), then the first `n` requests of `order` in the closed
    loop -> (Trace, n)."""
    prof = Profiler(device)
    prof.start()
    for _ in range(warm):
        with span('warm'):
            wait(dispatch(next(order)))
    closed_loop(dispatch, wait, order, float('inf'), outstanding,
                Outcome('traced'), lambda r: None, max_requests=n)
    prof.stop()
    return prof.trace, n


def _port_decode(model, streams):
    """An encode's streams decoded by the program; None where it cannot
    decode them."""
    try:
        return _decode_wait(_decode_dispatch(model, streams))
    except Exception:
        traceback.print_exc()
        return None


def run(spec, seed, seconds, trace, device, t0):
    """One run of a serving cell -> Outcome."""
    cfg, tr = spec.config, spec.traffic
    direction = tr['kind']
    B, H, W = tr['batch'], tr['height'], tr['width']
    out = Outcome(direction)
    var_u8 = inputs.variants(inputs.photos(tr))
    pool = inputs.request_pool(tr, seed, len(var_u8))
    batches = inputs.device_batches(pool, var_u8, device)
    model = system.build_model(cfg, seed, device)

    streams = None
    if direction == 'dec':
        streams = {q.index: _compress(model, batches[q.index], _lmbs(q, B))
                   for q in pool}

        def dispatch(q):
            return _decode_dispatch(model, streams[q.index])
        wait = _decode_wait
    else:
        def dispatch(q):
            lmbs = _lmbs(q, B)
            if lmbs is None:
                return model.compress_batch_async(batches[q.index])
            return model.compress_batch_async(batches[q.index], lmb=lmbs)
        wait = model.compress_batch_finish

    # warm-up: every request of the pool once, so every lane count and
    # shape of this cell is built before the window
    for q in pool:
        wait(dispatch(q))
    system.synchronize(device)
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    out.setup_s = time.perf_counter() - t0

    keep = Reservoir(tr['check_sample'], inputs.rng(seed, 4))
    order = inputs.order(pool, seed)
    latencies = closed_loop(dispatch, wait, order, seconds,
                            tr['outstanding'], out, keep.offer)
    if trace:
        # one whole cycle of the pool, so that every lambda of the mix is
        # in the trace in its share
        out.trace, out.traced_items = traced(
            dispatch, wait, inputs.order(pool, seed), len(pool),
            tr['outstanding'], device)
    if torch.device(device).type == 'cuda':
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    mpix = out.completed * B * H * W / 1e6
    key = 'dec_mpix_s' if direction == 'dec' else 'enc_mpix_s'
    out.end_to_end[key] = mpix / out.window_s
    out.end_to_end['req_p95_ms'] = float(
        np.percentile(np.array(latencies) * 1e3, 95)) if latencies else 0.0
    out.end_to_end['setup_s'] = out.setup_s
    out.flops_per_item = reference_flops(cfg['net'], direction, B, H, W)
    out.trunk_least_s = least_seconds(trunk_calls(cfg['net'], direction, B,
                                                  H, W))

    # correctness, once the window has closed and the peak is read: each
    # sampled request's images and the streams they were decoded from (an
    # encode's: the window's streams, decoded by the program's decoder,
    # the stage that the decode cells hold to the reference by itself; a
    # decode's: the streams it decoded, encoded by the program in set-up)
    samples = []
    for q, res in keep.items:
        if direction == 'enc':
            samples.append((q, _port_decode(model, res), res))
        else:
            samples.append((q, res, streams[q.index]))
    samples = [(q, None if ims is None else ims.to(torch.float16), st)
               for q, ims, st in samples]
    model = streams = None
    system.free(device)
    t = time.perf_counter()
    gaps = sample_gaps(cfg, seed, device, samples, batches, B)
    out.notes.update(gaps=gap_summary(gaps),
                     check_s=time.perf_counter() - t)
    for name, limit in spec.limits.items():
        v = gaps.get(CHECKS[name], [])
        out.check(name, max(v) if len(v) else float('inf'), limit)
    return out


@torch.no_grad()
def reference_code(ref, ims, lmb, B):
    """The reference's reconstruction of a request's images, (B, H, W, 3)
    float16 as the program returns them, and each image's ideal bits."""
    x = ims.permute(0, 3, 1, 2).contiguous()
    lmbs = None if lmb is None else torch.full((B,), float(np.float32(lmb)),
                                               device=x.device)
    im, bits = ref.code(x, lmbs)
    return im.permute(0, 2, 3, 1).to(torch.float16), bits


def sample_gaps(cfg, seed, device, samples, batches, B, tf32=False):
    """Per image of the sampled (request, images, streams), its gaps to the
    reference on the same input: {'differ': the share of the float16
    values in [0, 1] that differ from the reference's reconstruction,
    'rms': their RMS difference (for the record), 'rate': the stream's
    bits over the reference's ideal bits for the image, less 1}; inf
    where a result lacks an image or a stream or is not finite. The
    reference runs in float32 with TF32 off unless `tf32` (the control).
    A sample without streams (the control's) reads no rate."""
    system.set_tf32(tf32)
    ref = system.reference(cfg, seed, device)
    cache, gaps = {}, {k: [] for k in STATS}
    for q, res, st in samples:
        if q.index not in cache:
            cache[q.index] = reference_code(ref, batches[q.index], q.lmb, B)
        r, bits = cache[q.index]
        if st is not None:
            ideal = bits.clamp(min=1.0).tolist()     # at least a bit
            gaps['rate'] += [8.0 * stream_bytes(st[i]) / ideal[i] - 1.0
                             if i < len(st) else float('inf')
                             for i in range(B)]
        if res is None or tuple(res.shape) != tuple(r.shape):
            for k in ('differ', 'rms'):
                gaps[k] += [float('inf')] * B
            continue
        d = (res.float() - r.float()).abs().reshape(B, -1)
        bad = ~torch.isfinite(d).all(dim=1)
        vals = {'differ': (d != 0).float().mean(dim=1),
                'rms': d.square().mean(dim=1).sqrt()}
        for k, v in vals.items():
            gaps[k] += torch.where(bad, float('inf'), v).tolist()
    system.set_tf32(False)
    return {k: np.array(v) for k, v in gaps.items() if v}


def stream_bytes(obj):
    """The bytes of one image's stream: QARV's is bytes with its header,
    QRes-VAE's [body, shape] (the body counted, the four numbers of the
    shape not)."""
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    return sum(len(x) for x in obj if isinstance(x, (bytes, bytearray)))


STATS = ('differ', 'rms', 'rate')
# a limit's name in limits/<cell>.json -> the gap it holds, worst image
CHECKS = {'differ_gap': 'differ', 'rate_excess': 'rate'}


def gap_summary(gaps):
    """Quantiles over the images of each gap, for the record."""
    out = {}
    for k, v in gaps.items():
        q = np.quantile(v, [0.0, 0.5, 0.9, 1.0]) if len(v) else []
        out[k] = [float(x) for x in q]
    return out
