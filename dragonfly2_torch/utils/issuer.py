"""Certificate issuing (counterpart of the reference's ``utils/issuer.py``;
upstream pkg/issuer/ — the manager issues certs to services; the proxy spoofs leaf certs for HTTPS interception,
client/daemon/proxy/proxy.go:268-766).

Built on `cryptography`: a self-signed CA, server/leaf issuance with SAN
support, and an LRU-ish cache for the proxy's per-host spoofed certs.
PEM in, PEM out — consumers hand the bytes to ssl/grpc.
"""

from __future__ import annotations

import datetime
import ipaddress
import threading
from dataclasses import dataclass

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import rsa
from cryptography.x509.oid import NameOID

_ONE_DAY = datetime.timedelta(days=1)


@dataclass
class CertPair:
    cert_pem: bytes
    key_pem: bytes


def _key() -> rsa.RSAPrivateKey:
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _key_pem(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )


def _name(common_name: str) -> x509.Name:
    return x509.Name(
        [
            x509.NameAttribute(NameOID.ORGANIZATION_NAME, "dragonfly2-tpu"),
            x509.NameAttribute(NameOID.COMMON_NAME, common_name),
        ]
    )


def _san(hosts: list[str]) -> x509.SubjectAlternativeName:
    alts: list[x509.GeneralName] = []
    for h in hosts:
        try:
            alts.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            alts.append(x509.DNSName(h))
    return x509.SubjectAlternativeName(alts)


class CertificateAuthority:
    """Self-signed CA + leaf issuance (upstream pkg/issuer)."""

    def __init__(self, common_name: str = "dragonfly2-tpu CA", validity_days: int = 365):
        self._key = _key()
        now = datetime.datetime.now(datetime.timezone.utc)
        name = _name(common_name)
        self._cert = (
            x509.CertificateBuilder()
            .subject_name(name)
            .issuer_name(name)
            .public_key(self._key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + datetime.timedelta(days=validity_days))
            .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
            .add_extension(
                x509.KeyUsage(
                    digital_signature=True, key_cert_sign=True, crl_sign=True,
                    content_commitment=False, key_encipherment=False,
                    data_encipherment=False, key_agreement=False,
                    encipher_only=False, decipher_only=False,
                ),
                critical=True,
            )
            .sign(self._key, hashes.SHA256())
        )

    @property
    def cert_pem(self) -> bytes:
        return self._cert.public_bytes(serialization.Encoding.PEM)

    @property
    def key_pem(self) -> bytes:
        return _key_pem(self._key)

    def issue(
        self, common_name: str, hosts: list[str] | None = None, validity_days: int = 180
    ) -> CertPair:
        """Leaf cert for a server (or a spoofed origin host) signed by
        this CA, with SANs for every name/ip in ``hosts``."""
        key = _key()
        now = datetime.datetime.now(datetime.timezone.utc)
        builder = (
            x509.CertificateBuilder()
            .subject_name(_name(common_name))
            .issuer_name(self._cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + datetime.timedelta(days=validity_days))
            .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
            .add_extension(_san(hosts or [common_name]), critical=False)
        )
        cert = builder.sign(self._key, hashes.SHA256())
        return CertPair(cert.public_bytes(serialization.Encoding.PEM), _key_pem(key))

    def issue_from_csr(self, csr_pem: bytes, validity_days: int = 180) -> bytes:
        """Sign a client-submitted CSR (upstream securityv1
        IssueCertificate: the private key never leaves the requester).
        The CSR's own signature is verified first — a request whose
        proof-of-possession fails must not become a certificate. SANs
        and subject come from the CSR; CA capability is always denied."""
        csr = x509.load_pem_x509_csr(csr_pem)
        if not csr.is_signature_valid:
            raise ValueError("CSR signature invalid (no proof of key possession)")
        now = datetime.datetime.now(datetime.timezone.utc)
        builder = (
            x509.CertificateBuilder()
            .subject_name(csr.subject)
            .issuer_name(self._cert.subject)
            .public_key(csr.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + datetime.timedelta(days=validity_days))
            .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
        )
        try:
            san = csr.extensions.get_extension_for_class(x509.SubjectAlternativeName)
            builder = builder.add_extension(san.value, critical=False)
        except x509.ExtensionNotFound:
            pass
        cert = builder.sign(self._key, hashes.SHA256())
        return cert.public_bytes(serialization.Encoding.PEM)

    @staticmethod
    def load(cert_pem: bytes, key_pem: bytes) -> "CertificateAuthority":
        ca = CertificateAuthority.__new__(CertificateAuthority)
        ca._key = serialization.load_pem_private_key(key_pem, password=None)
        ca._cert = x509.load_pem_x509_certificate(cert_pem)
        return ca


def make_csr(common_name: str, hosts: list[str] | None = None) -> tuple[bytes, bytes]:
    """Client side of dynamic issuance: generate a key + CSR with SANs;
    → (key_pem, csr_pem). The key stays with the caller — only the CSR
    travels to the manager."""
    key = _key()
    csr = (
        x509.CertificateSigningRequestBuilder()
        .subject_name(_name(common_name))
        .add_extension(_san(hosts or [common_name]), critical=False)
        .sign(key, hashes.SHA256())
    )
    return _key_pem(key), csr.public_bytes(serialization.Encoding.PEM)


class SpoofingIssuer:
    """Per-host leaf cache for the MITM proxy (upstream proxy.go
    certificate spoofing): one cert per intercepted origin host, issued
    on first CONNECT and reused."""

    def __init__(self, ca: CertificateAuthority, max_cached: int = 256):
        self.ca = ca
        self.max_cached = max_cached
        self._cache: dict[str, CertPair] = {}
        self._lock = threading.Lock()
        self._issuing: dict[str, threading.Lock] = {}

    def for_host(self, host: str) -> CertPair:
        with self._lock:
            pair = self._cache.get(host)
            if pair is not None:
                return pair
            gate = self._issuing.setdefault(host, threading.Lock())
        # per-host gate: a burst of first CONNECTs to one registry must
        # run ONE RSA keygen, not one per handler thread
        with gate:
            with self._lock:
                pair = self._cache.get(host)
                if pair is not None:
                    return pair
            pair = self.ca.issue(host, hosts=[host])
            with self._lock:
                if len(self._cache) >= self.max_cached:
                    self._cache.pop(next(iter(self._cache)))
                self._cache[host] = pair
                self._issuing.pop(host, None)
                return pair


def obtain_certificate(
    manager_address: str,
    common_name: str,
    hosts: list[str] | None = None,
    validity_days: int = 180,
    token: str = "",
    **dial_kwargs,
) -> tuple[bytes, bytes, bytes]:
    """Dynamic issuance, client side (upstream pkg/rpc/security
    client): generate a key + CSR locally, submit to the manager's
    IssueCertificate, → (key_pem, leaf_cert_pem, ca_cert_pem). The
    private key never leaves this process; the returned triple plugs
    straight into rpc.glue serve/dial TLS arguments."""
    from dragonfly2_torch.rpc import glue, protos

    key_pem, csr_pem = make_csr(common_name, hosts)
    chan = glue.dial(manager_address, **dial_kwargs)
    try:
        manager_pb2 = protos.load("manager_pb2")

        client = glue.ServiceClient(chan, glue.MANAGER_SERVICE)
        resp = client.IssueCertificate(
            manager_pb2.CertificateRequest(
                csr_pem=csr_pem.decode(), validity_days=validity_days, token=token
            )
        )
    finally:
        chan.close()
    chain = list(resp.certificate_chain)
    if not chain:
        raise ValueError("manager returned an empty certificate chain")
    leaf = chain[0].encode()
    ca_pem = chain[-1].encode() if len(chain) > 1 else b""
    return key_pem, leaf, ca_pem
