"""100 % minus the share of the traced DiT batch in which a device event
(kernel, copy or fill) ran: ``device_idle_pct.dm``'s reading of the DM
cell's trace, applied to this cell's. The card sets the DiT sampler's
pace, so the profiler's host cost leaves this share as it is."""
from portbench import harness

read = harness.load_module("metrics", "device_idle_pct.dm").read
