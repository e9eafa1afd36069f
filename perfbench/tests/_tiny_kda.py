"""A copy of the benchmark whose hybrid LM configuration is cut to a few
thousand parameters per layer, for runs of the KDA cell on the CPU: every
mechanism kept (a dense first KDA layer, the (KDA, KDA, MLA, KDA) period
twice and the irregular (KDA, MLA) tail, rotary-free MLA, MoE layers with
the biased sigmoid router, a shared expert and a share of 2 of 16
experts), float32 compute, and limits for the CPU's float32 against
float32."""

import json

from _tiny import tiny_checkout

CELL = "kimi-linear-48b-a3b.kda-train"
KDA_LAYERS = [1, 2, 3, 5, 6, 7, 9, 10]
FULL_LAYERS = [4, 8, 11]
TINY = dict(num_hidden_layers=11, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, kv_lora_rank=32, moe_intermediate_size=32,
            intermediate_size=96, num_experts=2, num_experts_per_token=4,
            vocab_size=256)
LINEAR = dict(num_heads=2, head_dim=16, kda_layers=KDA_LAYERS,
              full_attn_layers=FULL_LAYERS)
# float32 on both sides: the sums' orders alone differ
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3,
          "route_gap": 1e-4, "kda_gap": 1e-5, "scan_gap": 1e-5,
          "expert_gap": 1e-5}


def tiny_kda_checkout(dest, compute="float32"):
    root = tiny_checkout(dest)
    p = root / "perfbench" / "configs" / "lm" / "kimi-linear-48b-a3b.json"
    c = json.loads(p.read_text())
    c.update(TINY)
    c["linear_attn_config"].update(LINEAR)
    c["published"] = {"num_experts": 16, "vocab_size": 2048}
    c["deployment"].update(expert_parallel=8)
    c["assumed"]["kda_gate_rank"] = 8
    c["model"]["compute_dtype"] = compute
    p.write_text(json.dumps(c))
    t = root / "perfbench" / "traffic" / "kda-train.json"
    traffic = json.loads(t.read_text())
    traffic.update(batch=2, seq_len=136)   # two whole chunks and a part
    t.write_text(json.dumps(traffic))
    (root / "perfbench" / "limits" / f"{CELL}.json").write_text(
        json.dumps(LIMITS))
    return root
