"""A copy of the benchmark whose LM configuration is cut to a few
thousand parameters per layer, for runs of the LM cell on the CPU: every
mechanism kept (MLA, the dense first layer, two checkpointed MoE layers,
the biased sigmoid router, shared experts, a share of 2 of 16 experts),
float32 compute, and limits for the CPU's float32 against float32."""

import json

from _tiny import tiny_checkout

CELL = "moonlight-16b-a3b.moe-train"
TINY = dict(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, kv_lora_rank=32, moe_intermediate_size=32,
            intermediate_size=96, n_routed_experts=2, num_experts_per_tok=4,
            vocab_size=256)
# float32 on both sides: the sums' orders alone differ
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3,
          "route_gap": 1e-4}


def tiny_lm_checkout(dest, compute="float32", **extra):
    root = tiny_checkout(dest)
    p = root / "perfbench" / "configs" / "lm" / "moonlight-16b-a3b.json"
    c = json.loads(p.read_text())
    c.update(TINY, **extra)
    c["published"] = {"n_routed_experts": 16, "vocab_size": 2048}
    c["model"]["compute_dtype"] = compute
    p.write_text(json.dumps(c))
    t = root / "perfbench" / "traffic" / "moe-train.json"
    traffic = json.loads(t.read_text())
    traffic.update(batch=2, seq_len=32)
    t.write_text(json.dumps(traffic))
    (root / "perfbench" / "limits" / f"{CELL}.json").write_text(
        json.dumps(LIMITS))
    return root
