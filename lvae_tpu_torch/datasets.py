"""Dataset configuration helpers, counterpart of the parser in
``lvae_tpu/datasets/image.py``."""


def parse_transform_cfg(cfg_str):
    """Parse 'crop=256,hflip=True' into a dict: booleans, then ints, then
    floats (safe, no eval). The eval CLIs read their -a model arguments
    with it."""
    out = {}
    if not cfg_str:
        return out
    for item in cfg_str.split(','):
        item = item.strip()
        if not item:
            continue
        k, _, v = item.partition('=')
        v = v.strip()
        if v.lower() in ('true', 'false'):
            out[k.strip()] = v.lower() == 'true'
        else:
            try:
                out[k.strip()] = int(v)
            except ValueError:
                out[k.strip()] = float(v)
    return out
