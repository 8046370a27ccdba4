"""Learning-rate schedules, a copy of ``lvae_tpu/training/schedules.py``:
computed on the host and passed into the train step as a number.
"""
import math

__all__ = ['get_cosine_factor', 'lr_factor']


def get_cosine_factor(t, T, final=0.01):
    """1 -> final as t goes 0 -> T."""
    return final + 0.5 * (1 - final) * (1 + math.cos(t * math.pi / T))


def lr_factor(t, T, sched='constant', warmup=0, lrf_min=0.01):
    """LR multiplier at step t of T."""
    if t < warmup:
        return (t + 1) / warmup
    if sched == 'constant':
        return 1.0
    if sched == 'cosine':
        return get_cosine_factor(t - warmup, T - warmup - 1, final=lrf_min)
    if sched == 'const-0.5-cos':
        boundary = round(T * 0.5)
        if t <= boundary:
            return 1.0
        return get_cosine_factor(t - boundary, T - boundary - 1, final=lrf_min)
    raise NotImplementedError(f'lr_sched = {sched} not implemented')
