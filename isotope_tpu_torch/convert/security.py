"""Large-scale security policy generator.

Capability parity with the reference's Go generator
(perf/benchmark/security/generate_policies/): a JSON config with the
same schema (README.md "Config file") produces AuthorizationPolicy /
PeerAuthentication / RequestAuthentication manifests at scale for authz
benchmarks, plus a signed RS256 bearer token whose issuer matches the
generated jwtRules — so a driver can exercise the allow path as well as
the N-deny-rule evaluation cost.

Synthetic rule values mirror generate.go exactly: paths
``/invalid-path-%d`` (:36), namespaces ``invalid-namespace-%d`` (:96),
principals ``cluster.local/ns/<ns>/sa/Invalid-%d`` (:109), sourceIPs
``0.0.%d.%d`` (:83), condition key ``request.headers[x-token]`` with
guest/admin values (:55-70), and request principals where only the last
is the valid ``issuer-<numJwks>/subject`` (:119-126).
"""
from __future__ import annotations

import base64
import dataclasses
import json
from typing import List, Optional, Tuple

import yaml


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


@dataclasses.dataclass(frozen=True)
class AuthZ:
    action: str = "DENY"
    num_namespaces: int = 0
    num_paths: int = 0
    num_policies: int = 0
    num_principals: int = 0
    num_source_ip: int = 0
    num_values: int = 0
    num_request_principals: int = 0
    dry_run: bool = False


@dataclasses.dataclass(frozen=True)
class PeerAuthN:
    mtls_mode: str = "STRICT"
    num_policies: int = 0


@dataclasses.dataclass(frozen=True)
class RequestAuthN:
    invalid_token: bool = False
    num_policies: int = 0
    num_jwks: int = 0
    token_issuer: str = ""


@dataclasses.dataclass(frozen=True)
class SecurityPolicyConfig:
    authz: AuthZ = AuthZ()
    namespace: str = "twopods-istio"
    peer_authn: PeerAuthN = PeerAuthN()
    request_authn: RequestAuthN = RequestAuthN()

    @classmethod
    def from_json(cls, text: str) -> "SecurityPolicyConfig":
        doc = json.loads(text)
        az = doc.get("authZ", {})
        pa = doc.get("peerAuthN", {})
        ra = doc.get("requestAuthN", {})
        return cls(
            authz=AuthZ(
                action=az.get("action", "DENY"),
                num_namespaces=az.get("numNamespaces", 0),
                num_paths=az.get("numPaths", 0),
                num_policies=az.get("numPolicies", 0),
                num_principals=az.get("numPrincipals", 0),
                num_source_ip=az.get("numSourceIP", 0),
                num_values=az.get("numValues", 0),
                num_request_principals=az.get("numRequestPrincipals", 0),
                dry_run=az.get("dryRun", False),
            ),
            namespace=doc.get("namespace", "twopods-istio"),
            peer_authn=PeerAuthN(
                mtls_mode=pa.get("mtlsMode", "STRICT"),
                num_policies=pa.get("numPolicies", 0),
            ),
            request_authn=RequestAuthN(
                invalid_token=ra.get("invalidToken", False),
                num_policies=ra.get("numPolicies", 0),
                num_jwks=ra.get("numJwks", 0),
                token_issuer=ra.get("tokenIssuer", ""),
            ),
        )


def _authz_rule(cfg: SecurityPolicyConfig) -> dict:
    """One Rule with from/to/when fan-out (generate.go's generators)."""
    az = cfg.authz
    rule: dict = {}
    froms: List[dict] = []
    if az.num_source_ip > 0:
        froms.append(
            {
                "source": {
                    "ipBlocks": [
                        f"0.0.{i // 256}.{i % 256}"
                        for i in range(az.num_source_ip)
                    ]
                }
            }
        )
    if az.num_namespaces > 0:
        froms.append(
            {
                "source": {
                    "namespaces": [
                        f"invalid-namespace-{i}"
                        for i in range(az.num_namespaces)
                    ]
                }
            }
        )
    if az.num_principals > 0:
        froms.append(
            {
                "source": {
                    "principals": [
                        f"cluster.local/ns/{cfg.namespace}/sa/Invalid-{i}"
                        for i in range(az.num_principals)
                    ]
                }
            }
        )
    if az.num_request_principals > 0:
        # the valid principal matches the token's issuer (jwtRules are
        # issuer-1..issuer-max(numJwks,1), the token signs as the last)
        valid_issuer = f"issuer-{max(cfg.request_authn.num_jwks, 1)}"
        principals = [
            "invalid-issuer/subject"
        ] * (az.num_request_principals - 1) + [
            f"{valid_issuer}/subject"
        ]
        froms.append({"source": {"requestPrincipals": principals}})
    if froms:
        rule["from"] = froms
    if az.num_paths > 0:
        rule["to"] = [
            {
                "operation": {
                    "paths": [
                        f"/invalid-path-{i}" for i in range(az.num_paths)
                    ]
                }
            }
        ]
    if az.num_values > 0:
        values = ["guest"] * az.num_values
        if az.action == "ALLOW":
            values[-1] = "admin"
        rule["when"] = [
            {"key": "request.headers[x-token]", "values": values}
        ]
    return rule


def _generate_key():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _jwks(private_key) -> str:
    """Inline JWKS for the key's public half (jwt.go:62-75)."""
    pub = private_key.public_key().public_numbers()
    n_bytes = pub.n.to_bytes((pub.n.bit_length() + 7) // 8, "big")
    e_bytes = pub.e.to_bytes((pub.e.bit_length() + 7) // 8, "big")
    # RFC 7518 base64urlUInt: unpadded (Go's RawURLEncoding likewise)
    return json.dumps(
        {
            "keys": [
                {
                    "kty": "RSA",
                    "e": _b64url(e_bytes),
                    "n": _b64url(n_bytes),
                }
            ]
        }
    )


def sign_token(private_key, issuer: str) -> str:
    """RS256 JWT with the reference's claims (jwt.go:44-47)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    header = _b64url(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    payload = _b64url(
        json.dumps({"iss": issuer, "sub": "subject"}).encode()
    )
    signing_input = f"{header}.{payload}".encode()
    sig = private_key.sign(
        signing_input, padding.PKCS1v15(), hashes.SHA256()
    )
    return f"{header}.{payload}.{_b64url(sig)}"


def generate_policies(
    cfg: SecurityPolicyConfig,
) -> Tuple[str, Optional[str]]:
    """All manifests as one multi-doc YAML, plus the bearer token (None
    when no RequestAuthentication policies are requested)."""
    docs: List[dict] = []
    az = cfg.authz
    rule = _authz_rule(cfg)  # identical across policies; build once
    for i in range(az.num_policies):
        spec: dict = {"action": az.action, "rules": [rule]}
        docs.append(
            {
                "apiVersion": "security.istio.io/v1beta1",
                "kind": "AuthorizationPolicy",
                "metadata": {
                    "name": f"test-authz-policy-{i}",
                    "namespace": cfg.namespace,
                    **(
                        {
                            "annotations": {
                                "istio.io/dry-run": "true"
                            }
                        }
                        if az.dry_run
                        else {}
                    ),
                },
                "spec": spec,
            }
        )

    for i in range(cfg.peer_authn.num_policies):
        docs.append(
            {
                "apiVersion": "security.istio.io/v1beta1",
                "kind": "PeerAuthentication",
                "metadata": {
                    "name": f"test-peer-authn-policy-{i}",
                    "namespace": cfg.namespace,
                },
                "spec": {"mtls": {"mode": cfg.peer_authn.mtls_mode}},
            }
        )

    token = None
    ra = cfg.request_authn
    if ra.num_policies > 0:
        key = _generate_key()
        jwks = _jwks(key)
        issuer = ra.token_issuer or f"issuer-{max(ra.num_jwks, 1)}"
        signing_key = _generate_key() if ra.invalid_token else key
        token = sign_token(signing_key, issuer)
        for i in range(ra.num_policies):
            docs.append(
                {
                    "apiVersion": "security.istio.io/v1beta1",
                    "kind": "RequestAuthentication",
                    "metadata": {
                        "name": f"test-request-authn-policy-{i}",
                        "namespace": cfg.namespace,
                    },
                    "spec": {
                        "jwtRules": [
                            {"issuer": f"issuer-{j + 1}", "jwks": jwks}
                            for j in range(max(ra.num_jwks, 1))
                        ]
                    },
                }
            )

    return yaml.safe_dump_all(docs, sort_keys=False), token
