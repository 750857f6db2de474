"""The same reading as `attn_fused_pct.sample`, for the DM cell, whose rate is its own
end-to-end metric (`dm_sample_windows_per_s`)."""
from portbench import harness

read = harness.load_module("metrics", "attn_fused_pct.sample").read
