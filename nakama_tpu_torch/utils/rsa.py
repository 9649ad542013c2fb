"""RSA keys and RSASSA-PKCS1-v1_5 signatures with SHA-256, standard
library only.

The port's stand-in for the parts of `cryptography` that the JAX
package's social verifier and IAP client use: RS256 JWT verification
against a JWK's `n` and `e`, Game Center's SHA-256 signature check with
the public key of an X.509 certificate, and the Google service-account
grant signed with a PEM private key. Private keys parse from DER or
PEM, PKCS#1 (`RSA PRIVATE KEY`) or PKCS#8 (`PRIVATE KEY`); public keys
from a JWK or as the subject public key of a DER X.509 certificate.
Python's `pow` does the arithmetic.
Verification rebuilds the whole encoded message (RFC 8017 §8.2.2) and
compares it, not a prefix. `generate_private_key`, `private_key_pem`
and `self_signed_certificate` make keys and a certificate to test with
(Miller–Rabin primes, `secrets`).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
from dataclasses import dataclass

# DigestInfo prefix of SHA-256 (RFC 8017 §9.2, note 1).
_SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")
_RSA_OID = "1.2.840.113549.1.1.1"
_SHA256_RSA_OID = "1.2.840.113549.1.1.11"


class RSAError(ValueError):
    """A key or certificate that does not parse, or is not RSA."""


class InvalidSignature(Exception):
    pass


@dataclass(frozen=True)
class PublicKey:
    n: int
    e: int

    def verify(self, signature: bytes, message: bytes) -> None:
        """RSASSA-PKCS1-v1_5 with SHA-256; raises `InvalidSignature`."""
        k = (self.n.bit_length() + 7) // 8
        if len(signature) != k:
            raise InvalidSignature("signature length differs from the key's")
        s = int.from_bytes(signature, "big")
        if s >= self.n:
            raise InvalidSignature("signature representative out of range")
        em = pow(s, self.e, self.n).to_bytes(k, "big")
        if not hmac.compare_digest(em, _encode_sha256(message, k)):
            raise InvalidSignature("signature mismatch")


@dataclass(frozen=True)
class PrivateKey:
    n: int
    e: int
    d: int
    p: int
    q: int

    def public_key(self) -> PublicKey:
        return PublicKey(self.n, self.e)

    def sign(self, message: bytes) -> bytes:
        """RSASSA-PKCS1-v1_5 with SHA-256 (deterministic)."""
        k = (self.n.bit_length() + 7) // 8
        m = int.from_bytes(_encode_sha256(message, k), "big")
        # CRT: the same value as pow(m, d, n), four times faster.
        dp, dq = self.d % (self.p - 1), self.d % (self.q - 1)
        m1, m2 = pow(m, dp, self.p), pow(m, dq, self.q)
        h = (pow(self.q, -1, self.p) * (m1 - m2)) % self.p
        return (m2 + h * self.q).to_bytes(k, "big")


def _encode_sha256(message: bytes, k: int) -> bytes:
    t = _SHA256_PREFIX + hashlib.sha256(message).digest()
    if k < len(t) + 11:
        raise InvalidSignature("key too short for a SHA-256 signature")
    return b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t


# ------------------------------------------------------------------ DER


def _read_tlv(data: bytes, off: int) -> tuple[int, int, int]:
    """(tag, value start, value end) of the element at `off`."""
    if off + 2 > len(data):
        raise RSAError("truncated DER element")
    tag = data[off]
    length = data[off + 1]
    off += 2
    if length & 0x80:
        count = length & 0x7F
        if count == 0 or count > 4 or off + count > len(data):
            raise RSAError("unsupported DER length")
        length = int.from_bytes(data[off:off + count], "big")
        off += count
    if off + length > len(data):
        raise RSAError("truncated DER element")
    return tag, off, off + length


def _children(data: bytes, start: int, end: int) -> list[tuple[int, int, int]]:
    out = []
    off = start
    while off < end:
        tag, vs, ve = _read_tlv(data, off)
        out.append((tag, vs, ve))
        off = ve
    return out


def _sequence(data: bytes, start: int = 0, end: int | None = None):
    tag, vs, ve = _read_tlv(data, start)
    if tag != 0x30:
        raise RSAError("expected a DER SEQUENCE")
    if end is not None and ve != end:
        raise RSAError("trailing data after a DER SEQUENCE")
    return _children(data, vs, ve)


def _integer(data: bytes, item) -> int:
    tag, vs, ve = item
    if tag != 0x02:
        raise RSAError("expected a DER INTEGER")
    return int.from_bytes(data[vs:ve], "big", signed=True)


def _oid(data: bytes, item) -> str:
    tag, vs, ve = item
    if tag != 0x06 or ve <= vs:
        raise RSAError("expected a DER OBJECT IDENTIFIER")
    raw = data[vs:ve]
    parts = [raw[0] // 40, raw[0] % 40]
    value = 0
    for b in raw[1:]:
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            parts.append(value)
            value = 0
    return ".".join(map(str, parts))


def _algorithm(data: bytes, item) -> str:
    tag, vs, ve = item
    if tag != 0x30:
        raise RSAError("expected an AlgorithmIdentifier")
    return _oid(data, _children(data, vs, ve)[0])


def _rsa_public_pkcs1(der: bytes) -> PublicKey:
    items = _sequence(der, 0, len(der))
    if len(items) != 2:
        raise RSAError("malformed RSAPublicKey")
    return _checked_public(_integer(der, items[0]), _integer(der, items[1]))


def _rsa_private_pkcs1(der: bytes) -> PrivateKey:
    items = _sequence(der, 0, len(der))
    if len(items) < 9 or _integer(der, items[0]) != 0:
        raise RSAError("malformed RSAPrivateKey")
    n, e, d, p, q = (_integer(der, items[i]) for i in range(1, 6))
    _checked_public(n, e)
    if p * q != n:
        raise RSAError("inconsistent RSA private key")
    return PrivateKey(n, e, d, p, q)


def _checked_public(n: int, e: int) -> PublicKey:
    if n <= 0 or n % 2 == 0 or e < 3 or e % 2 == 0 or e >= n:
        raise RSAError("invalid RSA public numbers")
    return PublicKey(n, e)


def _spki(der: bytes, item) -> PublicKey:
    """SubjectPublicKeyInfo ::= SEQUENCE { algorithm, BIT STRING }."""
    tag, vs, ve = item
    if tag != 0x30:
        raise RSAError("expected a SubjectPublicKeyInfo")
    algo, bits = _children(der, vs, ve)[:2]
    if _algorithm(der, algo) != _RSA_OID:
        raise RSAError("the key is not an RSA key")
    btag, bs, be = bits
    if btag != 0x03 or bs >= be or der[bs] != 0:
        raise RSAError("malformed subjectPublicKey")
    return _rsa_public_pkcs1(der[bs + 1:be])


def load_der_private_key(der: bytes) -> PrivateKey:
    """A DER PKCS#8 PrivateKeyInfo or PKCS#1 RSAPrivateKey."""
    items = _sequence(der, 0, len(der))
    if len(items) >= 3 and items[1][0] == 0x30:
        # PKCS#8: version, AlgorithmIdentifier, OCTET STRING.
        if _algorithm(der, items[1]) != _RSA_OID:
            raise RSAError("the key is not an RSA key")
        tag, vs, ve = items[2]
        if tag != 0x04:
            raise RSAError("malformed PrivateKeyInfo")
        return _rsa_private_pkcs1(der[vs:ve])
    return _rsa_private_pkcs1(der)


def load_der_certificate_public_key(der: bytes) -> PublicKey:
    """The subject public key of a DER X.509 certificate; only the path
    to it is parsed (no validity, chain or signature check, as the JAX
    verifier checks none)."""
    cert = _sequence(der, 0, len(der))
    if len(cert) != 3:
        raise RSAError("malformed certificate")
    tag, vs, ve = cert[0]
    if tag != 0x30:
        raise RSAError("malformed TBSCertificate")
    tbs = _children(der, vs, ve)
    # [0] version (optional), serial, signature, issuer, validity,
    # subject, subjectPublicKeyInfo.
    i = 1 if tbs and tbs[0][0] == 0xA0 else 0
    if len(tbs) < i + 6:
        raise RSAError("malformed TBSCertificate")
    return _spki(der, tbs[i + 5])


def _pem_blocks(text: str) -> list[tuple[str, bytes]]:
    blocks = []
    label = None
    body: list[str] = []
    for line in text.strip().splitlines():
        line = line.strip()
        if line.startswith("-----BEGIN ") and line.endswith("-----"):
            label, body = line[11:-5], []
        elif line.startswith("-----END ") and label is not None:
            try:
                blocks.append((label, base64.b64decode("".join(body),
                                                       validate=True)))
            except ValueError as e:
                raise RSAError("malformed PEM body") from e
            label = None
        elif label is not None:
            body.append(line)
    if not blocks:
        raise RSAError("no PEM block found")
    return blocks


def load_pem_private_key(pem: str | bytes) -> PrivateKey:
    text = pem.decode() if isinstance(pem, bytes) else pem
    for label, der in _pem_blocks(text):
        if label in ("PRIVATE KEY", "RSA PRIVATE KEY"):
            return load_der_private_key(der)
    raise RSAError("no RSA private key in the PEM text")


def _unb64url(data: str) -> bytes:
    return base64.urlsafe_b64decode(data + "=" * (-len(data) % 4))


def jwk_public_key(jwk: dict) -> PublicKey:
    """An RSA JWK's `n` and `e` (RFC 7518 §6.3.1)."""
    n = int.from_bytes(_unb64url(jwk["n"]), "big")
    e = int.from_bytes(_unb64url(jwk["e"]), "big")
    return _checked_public(n, e)


# ------------------------------------------------------- keys to test with


def _der(tag: int, value: bytes) -> bytes:
    n = len(value)
    if n < 0x80:
        head = bytes([tag, n])
    else:
        size = n.to_bytes((n.bit_length() + 7) // 8, "big")
        head = bytes([tag, 0x80 | len(size)]) + size
    return head + value


def _der_int(v: int) -> bytes:
    return _der(0x02, v.to_bytes(v.bit_length() // 8 + 1, "big", signed=True))


def _der_seq(*items: bytes) -> bytes:
    return _der(0x30, b"".join(items))


def _der_oid(oid: str) -> bytes:
    parts = [int(x) for x in oid.split(".")]
    out = bytearray([parts[0] * 40 + parts[1]])
    for v in parts[2:]:
        chunk = [v & 0x7F]
        v >>= 7
        while v:
            chunk.append(0x80 | (v & 0x7F))
            v >>= 7
        out += bytes(reversed(chunk))
    return _der(0x06, bytes(out))


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime(bits: int, e: int) -> int:
    while True:
        c = secrets.randbits(bits) | (3 << (bits - 2)) | 1
        if (c - 1) % e and _is_probable_prime(c):
            return c


def generate_private_key(bits: int = 2048, e: int = 65537) -> PrivateKey:
    while True:
        p, q = _prime(bits // 2, e), _prime(bits - bits // 2, e)
        n = p * q
        if p != q and n.bit_length() == bits:
            break
    d = pow(e, -1, (p - 1) * (q - 1))
    return PrivateKey(n, e, d, max(p, q), min(p, q))


def _pkcs1_private_der(key: PrivateKey) -> bytes:
    p, q, d = key.p, key.q, key.d
    return _der_seq(
        _der_int(0), _der_int(key.n), _der_int(key.e), _der_int(d),
        _der_int(p), _der_int(q), _der_int(d % (p - 1)), _der_int(d % (q - 1)),
        _der_int(pow(q, -1, p)),
    )


def _pem(label: str, der: bytes) -> str:
    b64 = base64.b64encode(der).decode()
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return "\n".join([f"-----BEGIN {label}-----", *lines,
                      f"-----END {label}-----", ""])


def private_key_pem(key: PrivateKey) -> str:
    """PKCS#8 PEM (the form of a Google service account's key)."""
    algo = _der_seq(_der_oid(_RSA_OID), b"\x05\x00")
    der = _der_seq(_der_int(0), algo, _der(0x04, _pkcs1_private_der(key)))
    return _pem("PRIVATE KEY", der)


def public_key_der(key: PublicKey) -> bytes:
    """DER SubjectPublicKeyInfo."""
    algo = _der_seq(_der_oid(_RSA_OID), b"\x05\x00")
    return _der_seq(algo, _der(0x03, b"\x00" + _der_seq(
        _der_int(key.n), _der_int(key.e))))


def self_signed_certificate(key: PrivateKey, common_name: str) -> bytes:
    """A DER X.509 v3 certificate of `key`'s public key, signed by it
    (sha256WithRSAEncryption), valid 2020–2049."""
    cn_oid = "2.5.4.3"
    name = _der_seq(_der(0x31, _der_seq(
        _der_oid(cn_oid), _der(0x0C, common_name.encode()))))
    validity = _der_seq(_der(0x17, b"200101000000Z"),
                        _der(0x17, b"491231235959Z"))
    sig_algo = _der_seq(_der_oid(_SHA256_RSA_OID), b"\x05\x00")
    tbs = _der_seq(
        _der(0xA0, _der_int(2)), _der_int(secrets.randbits(63) + 1), sig_algo,
        name, validity, name, public_key_der(key.public_key()),
    )
    signature = key.sign(tbs)
    return _der_seq(tbs, sig_algo, _der(0x03, b"\x00" + signature))
