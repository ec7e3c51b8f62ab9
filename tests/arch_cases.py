"""The architectures the port's tests run beside the reference, and the
smoke configs they take (both packages' copies cut alike).  Shared by the
CPU model, serving and MoE tests."""

import dataclasses

MOE_ARCHS = ("mixtral_8x7b", "llama4_maverick_400b")


def head_dim_32(cfg):
    """A config's attention heads widened to 32.  The overlay packs each
    unit's row of a vector leaf into 32-bit words, so qwen3's q/k norms of
    the smoke size's 16 entries are not coverable (``plan_overlay``
    returns None in both packages) and their deltas would go untested."""
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(b.attn, head_dim=32))
        for b in cfg.pattern))


def smoke_configs(arch: str, n_units: int = 2):
    """(reference config, port config): the smoke configs at ``n_units``,
    qwen3's with heads of 32."""
    from repro.configs import get_smoke_config
    from repro_torch.configs import get_smoke_config as t_smoke
    jcfg = get_smoke_config(arch, n_units=n_units)
    tcfg = t_smoke(arch, n_units=n_units)
    if arch == "qwen3_32b":
        jcfg, tcfg = head_dim_32(jcfg), head_dim_32(tcfg)
    return jcfg, tcfg
