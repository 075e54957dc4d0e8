"""The port's certificate issuance (``utils/issuer.py`` behind the manager's
``IssueCertificate``) against the reference's.

Certificates cannot be compared byte for byte — keys and serials are
random — so each side's certificates are held to the same subject, SANs,
validity, basic constraints and issuer, and each chain must verify
against its CA. Clients and managers are crossed: the port's
``obtain_certificate`` against the reference's manager and the other way
round. The token gate, the validity cap, an unparsable CSR and a manager
without a CA abort with the reference's codes (``tests/test_cert_issuance.py``),
an issued pair terminates TLS on the port's gRPC, and the manager server
persists its CA and loads it back."""

import datetime
import os
import stat

import grpc
import pytest
import torch
from cryptography import x509
from cryptography.hazmat.primitives.asymmetric import padding

from dragonfly2_torch.manager import database as t_database
from dragonfly2_torch.manager import models_registry as t_registry
from dragonfly2_torch.manager import objectstorage as t_objectstorage
from dragonfly2_torch.manager import server as t_server
from dragonfly2_torch.manager import service as t_service
from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.utils import issuer as t_issuer
from dragonfly2_tpu.manager import database as j_database
from dragonfly2_tpu.manager import models_registry as j_registry
from dragonfly2_tpu.manager import objectstorage as j_objectstorage
from dragonfly2_tpu.manager import server as j_server
from dragonfly2_tpu.manager import service as j_service
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.utils import issuer as j_issuer

torch.set_num_threads(1)

mp = protos.load("manager_pb2")

PKGS = {
    "torch": (t_database, t_registry, t_objectstorage, t_service, t_glue, t_issuer),
    "jax": (j_database, j_registry, j_objectstorage, j_service, j_glue, j_issuer),
}


@pytest.fixture
def managers(tmp_path):
    """A served ManagerService with a CA in each package (and one gated
    by a token) → {name: {"addr", "gated", "ca"}}."""
    out, stops = {}, []
    for name, (database, registry, storage, service, glue, issuer) in PKGS.items():
        entry = {}
        for kind, token in (("addr", ""), ("gated", "join-secret")):
            db = database.Database(tmp_path / f"{name}-{kind}.db")
            ca = issuer.CertificateAuthority(common_name=f"{name} CA")
            svc = service.ManagerService(db, registry.ModelRegistry(db, storage.FSObjectStorage(
                tmp_path / f"{name}-{kind}")), ca=ca, ca_token=token)
            server, port = glue.serve({glue.MANAGER_SERVICE: svc})
            entry[kind] = f"127.0.0.1:{port}"
            entry.setdefault("ca", ca)
            stops.append((server, db))
        out[name] = entry
    yield out
    for server, db in stops:
        server.stop(0)
        db.close()


def _view(leaf_pem: bytes, ca_pem: bytes) -> dict:
    """What two issuances must share; the chain is verified on the way."""
    leaf, ca = x509.load_pem_x509_certificate(leaf_pem), x509.load_pem_x509_certificate(ca_pem)
    ca.public_key().verify(leaf.signature, leaf.tbs_certificate_bytes, padding.PKCS1v15(),
                           leaf.signature_hash_algorithm)
    assert leaf.issuer == ca.subject
    try:
        sans = leaf.extensions.get_extension_for_class(x509.SubjectAlternativeName).value
        names = sorted(str(n.value) for n in sans)
    except x509.ExtensionNotFound:
        names = []
    bc = leaf.extensions.get_extension_for_class(x509.BasicConstraints)
    return {
        "subject": leaf.subject.rfc4514_string(),
        "sans": names,
        "validity": leaf.not_valid_after_utc - leaf.not_valid_before_utc,
        "ca": (bc.value.ca, bc.critical),
        "key_bits": leaf.public_key().key_size,
    }


@pytest.mark.parametrize("client", ["torch", "jax"])
@pytest.mark.parametrize("days", [180, 1, 366])
def test_issued_certificates_match(managers, client, days):
    obtain = PKGS[client][5].obtain_certificate
    views = {}
    for name, entry in managers.items():
        key, leaf, ca = obtain(entry["addr"], "scheduler-x", hosts=["localhost", "127.0.0.1", "s.example"],
                               validity_days=days)
        assert b"PRIVATE KEY" in key and ca == entry["ca"].cert_pem
        views[name] = _view(leaf, ca)
    assert views["torch"] == views["jax"]
    assert views["torch"]["sans"] == ["127.0.0.1", "localhost", "s.example"]
    assert views["torch"]["validity"] == datetime.timedelta(days=days + 1)  # backdated a day
    assert views["torch"]["ca"] == (False, True)
    assert views["torch"]["subject"] == "CN=scheduler-x,O=dragonfly2-tpu"


def test_the_gate_the_cap_and_bad_csrs_abort_alike(managers):
    codes = {}
    for name, entry in managers.items():
        obtain = PKGS[name][5].obtain_certificate
        got = []
        for addr, token in ((entry["gated"], ""), (entry["gated"], "wrong")):
            with pytest.raises(grpc.RpcError) as e:
                obtain(addr, "rogue", token=token)
            got.append(e.value.code())
        _, leaf, ca = obtain(entry["gated"], "legit", token="join-secret")
        got.append(_view(leaf, ca)["subject"])
        channel = t_glue.dial(entry["addr"])
        client = t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE)
        _, csr = t_issuer.make_csr("x")
        for req in (mp.CertificateRequest(csr_pem="not a csr", validity_days=10),
                    mp.CertificateRequest(csr_pem=csr.decode(), validity_days=367)):
            with pytest.raises(grpc.RpcError) as e:
                client.IssueCertificate(req)
            got.append(e.value.code())
        channel.close()
        codes[name] = got
    assert codes["torch"] == codes["jax"] == [
        grpc.StatusCode.PERMISSION_DENIED, grpc.StatusCode.PERMISSION_DENIED, "CN=legit,O=dragonfly2-tpu",
        grpc.StatusCode.INVALID_ARGUMENT, grpc.StatusCode.INVALID_ARGUMENT]


def test_issuance_is_disabled_without_a_ca(tmp_path):
    codes = []
    for name, (database, registry, storage, service, glue, issuer) in PKGS.items():
        db = database.Database(tmp_path / f"{name}.db")
        svc = service.ManagerService(db, registry.ModelRegistry(db, storage.FSObjectStorage(tmp_path / name)))
        server, port = glue.serve({glue.MANAGER_SERVICE: svc})
        try:
            with pytest.raises(grpc.RpcError) as e:
                issuer.obtain_certificate(f"127.0.0.1:{port}", "y")
            codes.append(e.value.code())
        finally:
            server.stop(0)
            db.close()
    assert codes == [grpc.StatusCode.UNIMPLEMENTED] * 2


def test_an_issued_pair_terminates_tls(managers, tmp_path):
    key, leaf, ca = t_issuer.obtain_certificate(managers["torch"]["addr"], "scheduler-x",
                                                hosts=["localhost", "127.0.0.1"])
    db = t_database.Database(tmp_path / "tls.db")
    svc = t_service.ManagerService(db, t_registry.ModelRegistry(db, t_objectstorage.FSObjectStorage(tmp_path / "o")))
    server, port = t_glue.serve({t_glue.MANAGER_SERVICE: svc}, tls=(key, leaf))
    try:
        channel = t_glue.dial(f"127.0.0.1:{port}", tls_ca=ca, tls_server_name="localhost")
        assert list(t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE).ListSchedulers(
            mp.ListSchedulersRequest()).schedulers) == []
        channel.close()
    finally:
        server.stop(0)
        db.close()


def test_server_leaves_and_spoofed_certificates_match():
    views = {}
    for name, mod in (("torch", t_issuer), ("jax", j_issuer)):
        ca = mod.CertificateAuthority(common_name="proxy CA", validity_days=30)
        root = x509.load_pem_x509_certificate(ca.cert_pem)
        pair = ca.issue("registry.example", hosts=["registry.example", "10.1.2.3"], validity_days=7)
        spoof = mod.SpoofingIssuer(ca, max_cached=2)
        first = spoof.for_host("a.example")
        assert spoof.for_host("a.example") is first
        spoof.for_host("b.example")
        spoof.for_host("c.example")  # evicts a.example
        again = spoof.for_host("a.example")
        reloaded = mod.CertificateAuthority.load(ca.cert_pem, ca.key_pem)
        views[name] = (
            root.subject.rfc4514_string(), root.not_valid_after_utc - root.not_valid_before_utc,
            _view(pair.cert_pem, ca.cert_pem), _view(first.cert_pem, ca.cert_pem), again is first,
            _view(reloaded.issue("x").cert_pem, ca.cert_pem)["subject"],
        )
    assert views["torch"] == views["jax"]
    assert views["torch"][2]["sans"] == ["10.1.2.3", "registry.example"] and views["torch"][4] is False


def test_the_manager_persists_its_ca(tmp_path):
    got = {}
    for name, mod in (("torch", t_server), ("jax", j_server)):
        cfg = mod.ManagerServerConfig(data_dir=str(tmp_path / name))
        ca_dir = tmp_path / name / "ca"
        ca_dir.parent.mkdir()
        first = mod.ManagerServer._load_ca(cfg)
        second = mod.ManagerServer._load_ca(cfg)
        mode = stat.S_IMODE(os.stat(ca_dir / "ca.key").st_mode)
        got[name] = (first.cert_pem == second.cert_pem == (ca_dir / "ca.crt").read_bytes(), oct(mode),
                     x509.load_pem_x509_certificate(first.cert_pem).subject.rfc4514_string(),
                     mod.ManagerServer._load_ca(mod.ManagerServerConfig(data_dir=str(tmp_path), issue_certs=False)))
    assert got["torch"] == got["jax"] == (True, "0o600", "CN=dragonfly2-tpu manager CA,O=dragonfly2-tpu", None)
