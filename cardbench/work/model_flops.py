"""The model's operations per token, from the configuration's shapes:
2 per weight of every matrix a token passes (for mixtral, the router and
the two experts it is routed to), and 4 * heads * head size per earlier
position it attends to, per layer (scores and values).  The expert
overlay's extra products are not the model's: they are kernel 1's work."""


def matrix_params(cfg: dict) -> int:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    per = d * q * 2 + d * kv * 2
    if cfg.get("num_local_experts"):
        per += d * cfg["num_local_experts"] + cfg["num_experts_per_tok"] * \
            3 * d * f
    else:
        per += 3 * d * f
    return per * cfg["num_hidden_layers"] + d * cfg["vocab_size"]


def token(cfg: dict, context: int) -> float:
    """Operations of one token that attends to ``context`` positions."""
    win = _window(cfg)
    ctx = min(context, win) if win else context
    att = 4 * ctx * cfg["num_attention_heads"] * cfg["head_dim"] * \
        cfg["num_hidden_layers"]
    return 2 * matrix_params(cfg) + att


def sequence(cfg: dict, prompt: int, generated: int) -> float:
    """Operations of a request: its prompt's tokens and the generated
    tokens fed back, each attending to the positions up to its own."""
    L = prompt + generated
    att = 4 * cfg["num_attention_heads"] * cfg["head_dim"] * \
        cfg["num_hidden_layers"]
    win = _window(cfg)
    if win is None or win >= L:
        ctx = L * (L + 1) // 2
    else:
        ctx = win * (win + 1) // 2 + (L - win) * win
    return 2 * matrix_params(cfg) * L + att * ctx


def _window(cfg: dict):
    return cfg.get("sliding_window") if cfg.get("use_sliding_window", True) \
        else None
