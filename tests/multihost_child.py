"""Child process for the 2-process multi-host smoke test (not a pytest file).

Usage: python multihost_child.py <process_id> <coordinator_port>

Each process contributes 4 virtual CPU devices (8 global) and runs:
  1. ``initialize_distributed`` against a localhost coordinator
     (the multi-host entry this library adds over the single-JVM
     reference, SURVEY.md §5.8),
  2. a cross-process ``batch_sharded`` WPT on a global array assembled
     from process-local shards,
  3. a cross-process halo-exchange MODWT (``ppermute`` rides the Gloo
     CPU collectives here).
Every local shard is checked against a single-device computation of the
full problem (both processes build identical inputs from a shared seed).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

pid = int(sys.argv[1])
port = int(sys.argv[2])

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jwave_tpu.parallel import initialize_distributed, batch_sharded, modwt_halo_sharded
import jwave_tpu as jw

i, n = initialize_distributed(f"127.0.0.1:{port}", 2, pid)
assert (i, n) == (pid, 2), (i, n)
assert len(jax.local_devices()) == 4 and len(jax.devices()) == 8

mesh = Mesh(np.asarray(jax.devices()), ("shard",))
sharding = NamedSharding(mesh, P("shard"))
rng = np.random.default_rng(42)  # same seed in both processes

# --- cross-process batch-sharded WPT ---------------------------------------
batch = rng.standard_normal((8, 256))
gx = jax.make_array_from_process_local_data(sharding, batch[4 * pid : 4 * (pid + 1)])
y = batch_sharded(lambda b: jw.wpt(b, "db2", 3), mesh)(gx)
want = np.asarray(jw.wpt(jnp.asarray(batch), "db2", 3))
for shard in y.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data), want[shard.index], atol=1e-10)
print(f"proc {pid}: batch_sharded WPT ok", flush=True)

# --- cross-process halo MODWT (ppermute over the process boundary) ---------
sig = rng.standard_normal(2048)
gs = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("shard")), sig[256 * 4 * pid : 256 * 4 * (pid + 1)]
)
coeffs = modwt_halo_sharded(gs, "db2", 3, mesh)
want_c = np.asarray(jw.modwt(jnp.asarray(sig), "db2", 3))
for shard in coeffs.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data), want_c[shard.index], atol=1e-10)
print(f"proc {pid}: halo MODWT ok", flush=True)

print(f"proc {pid}: MULTIHOST_OK", flush=True)
