"""The port's config file (``tendermint_tpu_torch/config.py``) against the
JAX package's ``tendermint_tpu/config.py``, on the CPU: the twin of
``tests/test_cli.py::TestConfigToml``.

The file's schema is the JAX package's key for key: a ``config.toml``
that either package writes loads in the other, field for field, and the
two emit the same text for the same values. The held divergences
(ROADMAP §C): ``[ops] mesh_devices`` above 1 is refused until the
multi-GPU engine; the empty values that the JAX package lets an
environment variable fill (``base.trace``, ``ops.verify_remote``,
``ops.resident_tables``, ``ops.verify_shm``) keep the port's default, and
the port reads no environment.
"""

import dataclasses
import os

import pytest

pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.config import Config as JConfig
from tendermint_tpu_torch.config import Config

SECTIONS = ("base", "p2p", "rpc", "mempool", "statesync", "privval", "consensus", "indexer", "ops")


def _section_values(cfg):
    return {s: dataclasses.asdict(getattr(cfg, s)) for s in SECTIONS}


def _set_everything(cfg):
    """Every field of every section away from its default."""
    cfg.base.moniker = "alpha"
    cfg.base.log_level = "debug"
    cfg.base.mode = "seed"
    cfg.base.proxy_app = "grpc://127.0.0.1:26658"
    cfg.base.db_backend = "filedb-py"
    cfg.base.blocksync = False
    cfg.base.wal_enabled = False
    cfg.base.app_snapshot_interval = 7
    cfg.base.trace = "ring"
    cfg.p2p.laddr = "127.0.0.1:11111"
    cfg.p2p.persistent_peers = ["aa@1.2.3.4:5", "bb@6.7.8.9:10"]
    cfg.p2p.max_connections = 3
    cfg.p2p.send_rate = 1000
    cfg.p2p.recv_rate = 2000
    cfg.p2p.queue_type = "priority"
    cfg.rpc.laddr = "127.0.0.1:22222"
    cfg.rpc.unsafe = True
    cfg.mempool.size = 77
    cfg.mempool.max_txs_bytes = 1 << 20
    cfg.mempool.cache_size = 5
    cfg.mempool.max_tx_bytes = 999
    cfg.mempool.ttl_duration = 1.5
    cfg.mempool.ttl_num_blocks = 4
    cfg.mempool.recheck = False
    cfg.mempool.keep_invalid_txs_in_cache = True
    cfg.statesync.enabled = True
    cfg.statesync.trust_height = 42
    cfg.statesync.trust_hash = b"\xab\xcd" * 16
    cfg.statesync.trust_period = 3600.0
    cfg.statesync.discovery_time = 0.5
    cfg.statesync.chunk_fetchers = 2
    cfg.statesync.chunk_timeout = 3.0
    cfg.statesync.light_block_timeout = 4.0
    cfg.statesync.backfill_blocks = 9
    cfg.statesync.max_clock_drift = 1.0
    cfg.privval.laddr = "tcp://127.0.0.1:33333"
    cfg.privval.connect_timeout = 5.0
    cfg.consensus.double_sign_check_height = 3
    cfg.indexer.enabled = False
    cfg.indexer.sinks = ["null", "sql"]
    cfg.ops.verify_remote = "127.0.0.1:26670"
    cfg.ops.verify_tenant = "chain-a"
    cfg.ops.mesh_devices = 1
    cfg.ops.resident_tables = "on"
    cfg.ops.verify_shm = "off"
    return cfg


# --- the twins of test_cli.py::TestConfigToml ---------------------------------------


class TestConfigToml:
    def test_roundtrip(self, tmp_path):
        cfg = Config(home=str(tmp_path))
        cfg.base.moniker = "alpha"
        cfg.base.proxy_app = "persistent_kvstore"
        cfg.p2p.laddr = "127.0.0.1:11111"
        cfg.p2p.persistent_peers = ["aa@1.2.3.4:5", "bb@6.7.8.9:10"]
        cfg.rpc.laddr = "127.0.0.1:22222"
        cfg.mempool.size = 77
        cfg.statesync.enabled = True
        cfg.statesync.trust_height = 42
        cfg.statesync.trust_hash = b"\xab\xcd"
        cfg.privval.laddr = "tcp://127.0.0.1:33333"
        cfg.save()

        loaded = Config.load(str(tmp_path))
        assert loaded.base.moniker == "alpha"
        assert loaded.base.proxy_app == "persistent_kvstore"
        assert loaded.p2p.persistent_peers == cfg.p2p.persistent_peers
        assert loaded.mempool.size == 77
        assert loaded.statesync.enabled is True
        assert loaded.statesync.trust_height == 42
        assert loaded.statesync.trust_hash == b"\xab\xcd"
        assert loaded.privval.laddr == "tcp://127.0.0.1:33333"

    def test_to_node_config(self, tmp_path):
        cfg = Config(home=str(tmp_path))
        cfg.statesync.enabled = False
        nc = cfg.to_node_config(chain_id="x")
        assert nc.chain_id == "x"
        assert nc.statesync is None  # disabled -> not wired
        cfg.statesync.enabled = True
        assert cfg.to_node_config().statesync is cfg.statesync

    def test_unknown_keys_ignored(self, tmp_path):
        text = '[base]\nmoniker = "m"\nfuture_knob = 3\n[bogus]\nx = 1\n'
        cfg = Config.from_toml(text)
        assert cfg.base.moniker == "m"


# --- across the packages -------------------------------------------------------------


def test_the_schema_is_the_references_key_for_key():
    for s in SECTIONS:
        port = [(f.name, f.type) for f in dataclasses.fields(getattr(Config(), s))]
        jax = [(f.name, f.type) for f in dataclasses.fields(getattr(JConfig(), s))]
        assert port == jax, s
    assert Config().to_toml() == JConfig().to_toml()
    assert _set_everything(Config()).to_toml() == _set_everything(JConfig()).to_toml()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_config_file_written_by_either_package_loads_in_the_other_field_for_field(tmp_path, writer):
    write_cls, read_cls = (Config, JConfig) if writer == "port" else (JConfig, Config)
    wrote = _set_everything(write_cls(home=str(tmp_path)))
    wrote.save()
    got = read_cls.load(str(tmp_path))
    assert got.home == str(tmp_path)
    assert _section_values(got) == _section_values(wrote)
    # and back, byte for byte
    assert got.to_toml() == wrote.to_toml()


def test_a_jax_default_config_gives_the_ports_node_config_the_same_fields(tmp_path):
    JConfig(home=str(tmp_path)).save()
    port = Config.load(str(tmp_path)).to_node_config(chain_id="c")
    jax = JConfig.load(str(tmp_path)).to_node_config(chain_id="c")
    port_fields = {f.name for f in dataclasses.fields(port)}
    jax_fields = {f.name for f in dataclasses.fields(jax)}
    assert jax_fields - port_fields == {"mesh_devices"}  # item 10
    for name in port_fields:
        a, b = getattr(port, name), getattr(jax, name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, name


# --- held divergences ----------------------------------------------------------------


@pytest.mark.parametrize("mesh", [0, 1])
def test_mesh_devices_0_and_1_mean_the_one_card(mesh):
    cfg = Config()
    cfg.ops.mesh_devices = mesh
    assert not hasattr(cfg.to_node_config(), "mesh_devices")


@pytest.mark.parametrize("mesh", [2, 8])
def test_mesh_devices_above_1_is_refused_until_item_10(tmp_path, mesh):
    jcfg = JConfig(home=str(tmp_path))
    jcfg.ops.mesh_devices = mesh
    jcfg.save()
    assert jcfg.to_node_config().mesh_devices == mesh  # the reference takes it
    cfg = Config.load(str(tmp_path))
    assert cfg.ops.mesh_devices == mesh  # the key stays in the file
    with pytest.raises(ValueError, match="item 10"):
        cfg.to_node_config()


@pytest.fixture
def node_sinks_restored(monkeypatch):
    """A node built here binds process-wide units; put them back."""
    from tendermint_tpu_torch import ops as tops
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.libs import tracing
    from tendermint_tpu_torch.ops import introspect, resident
    from tendermint_tpu_torch.verifyd import client as vclient, shm

    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(crypto_batch, "_shared_scheduler", None)
    saved = (tracing.tracer._observer, tracing.tracer._profile, introspect.profiler._enabled,
             tracing.tracer.mode, resident.store._mode)
    yield
    crypto_batch.shutdown_shared_scheduler()
    observer, profile, enabled, mode, res_mode = saved
    introspect.profiler._enabled = enabled
    tracing.tracer.set_metrics_observer(observer)
    tracing.tracer.set_profile_sink(profile)
    tracing.configure(mode)
    resident.configure(res_mode)
    tops.bind_metrics(None)
    vclient.reset_remote()
    shm.set_shm_mode("")


def _node_from(cfg):
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.privval import FilePV
    from tests.test_torch_node import fast_genesis

    os.makedirs(cfg.config_dir(), exist_ok=True)
    os.makedirs(cfg.data_dir(), exist_ok=True)
    pv = FilePV.generate(cfg.privval_key_file(), cfg.privval_state_file())
    node = Node(cfg.to_node_config(chain_id="cfg-chain"), fast_genesis([pv], chain="cfg-chain"),
                LocalClient(KVStoreApplication()), priv_validator=pv)
    node._close_stores()
    return node


def test_empty_values_keep_the_ports_defaults_and_no_environment_is_read(tmp_path, monkeypatch,
                                                                          node_sinks_restored):
    """The JAX package fills these from TENDERMINT_TPU_TRACE,
    _VERIFY_REMOTE, _RESIDENT and _SHM; the port's node keeps the tracer
    off, verifies locally, lets the resident store follow the device and
    the shm ingress negotiate."""
    from tendermint_tpu_torch.libs import tracing
    from tendermint_tpu_torch.ops import resident
    from tendermint_tpu_torch.verifyd import client as vclient, shm

    for knob, value in (("TRACE", "ring"), ("VERIFY_REMOTE", "127.0.0.1:9"), ("RESIDENT", "on"), ("SHM", "off")):
        monkeypatch.setenv(f"TENDERMINT_TPU_{knob}", value)
    tracing.configure("off")
    resident.configure(None)
    cfg = Config(home=str(tmp_path))
    cfg.base.db_backend = "memdb"
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.save()
    loaded = Config.load(str(tmp_path))
    assert (loaded.base.trace, loaded.ops.verify_remote, loaded.ops.resident_tables, loaded.ops.verify_shm) == \
        ("", "", "", "")
    _node_from(loaded)
    assert tracing.tracer.mode == "off"
    assert vclient._remote_addr == ""
    assert resident.store._mode is None and resident.enabled("cuda") and not resident.enabled("cpu")
    assert shm.shm_mode() == "auto"


def test_resident_tables_auto_from_a_jax_config_follows_the_device(tmp_path, node_sinks_restored):
    """The JAX package writes ``resident_tables = "auto"``; the port's
    node takes it as the store's own default rather than refusing it."""
    from tendermint_tpu_torch.ops import resident

    jcfg = JConfig(home=str(tmp_path))
    jcfg.ops.resident_tables = "auto"
    jcfg.base.db_backend = "memdb"
    jcfg.rpc.laddr = ""
    jcfg.p2p.laddr = "127.0.0.1:0"
    jcfg.save()
    resident.configure("off")
    _node_from(Config.load(str(tmp_path)))
    assert resident.store._mode is None
