"""Security SPI: authentication and access control.

Reference blueprint: io.trino.spi.security.SystemAccessControl (checkCanXxx
methods raising AccessDeniedException), the file-based access control plugin
(plugin/trino-file-based-access-control: table rules matched first-wins with
user/catalog/schema/table regexes and privilege lists), and
PasswordAuthenticator (plugin/trino-password-authenticators' file authenticator
with user:bcrypt lines — here sha256, no external deps).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class AccessDeniedError(PermissionError):
    """spi/security/AccessDeniedException analogue."""

    def __init__(self, what: str):
        super().__init__(f"Access Denied: {what}")


class AuthenticationError(PermissionError):
    pass


# --------------------------------------------------------------------------- #
# access control
# --------------------------------------------------------------------------- #

PRIVILEGES = ("SELECT", "INSERT", "DELETE", "UPDATE", "OWNERSHIP")


class AccessControl:
    """Allow-all base contract (SystemAccessControl). Override checks to
    restrict; every check raises AccessDeniedError on denial."""

    def check_can_execute_query(self, user: str) -> None:
        pass

    def check_can_access_catalog(self, user: str, catalog: str) -> None:
        pass

    def check_can_select(self, user: str, catalog: str, schema: str, table: str,
                         columns: Sequence[str] = ()) -> None:
        pass

    def check_can_insert(self, user: str, catalog: str, schema: str, table: str) -> None:
        pass

    def check_can_delete(self, user: str, catalog: str, schema: str, table: str) -> None:
        pass

    def check_can_update(self, user: str, catalog: str, schema: str, table: str) -> None:
        pass

    def check_can_create_table(self, user: str, catalog: str, schema: str, table: str) -> None:
        pass

    def check_can_drop_table(self, user: str, catalog: str, schema: str, table: str) -> None:
        pass

    def check_can_create_view(self, user: str, catalog: str, schema: str, view: str) -> None:
        pass

    def check_can_drop_view(self, user: str, catalog: str, schema: str, view: str) -> None:
        pass

    def filter_catalogs(self, user: str, catalogs: Iterable[str]) -> List[str]:
        return list(catalogs)

    def filter_tables(self, user: str, catalog: str, tables: Iterable) -> List:
        """``tables`` are SchemaTableNames; drop the ones the user has no
        privilege on at all (SystemAccessControl.filterTables)."""
        return list(tables)

    def grant(self, granter, privileges, catalog, schema, table, grantee):
        raise AccessDeniedError("this access control does not support GRANT")

    def revoke(self, granter, privileges, catalog, schema, table, grantee):
        raise AccessDeniedError("this access control does not support REVOKE")

    def filter_schemas(self, user: str, catalog: str, schemas: Iterable[str]) -> List[str]:
        """SystemAccessControl.filterSchemas."""
        return list(schemas)


class AllowAllAccessControl(AccessControl):
    """Everything permitted; GRANT/REVOKE are accepted no-ops (there is
    nothing to restrict)."""

    def grant(self, granter, privileges, catalog, schema, table, grantee):
        return None

    def revoke(self, granter, privileges, catalog, schema, table, grantee):
        return None


@dataclass(frozen=True)
class TableRule:
    """One rule; None pattern = match anything (file-based plugin's shape)."""

    user: Optional[str] = None
    catalog: Optional[str] = None
    schema: Optional[str] = None
    table: Optional[str] = None
    privileges: Tuple[str, ...] = ()

    def matches(self, user: str, catalog: str, schema: str, table: str) -> bool:
        for pattern, value in (
            (self.user, user),
            (self.catalog, catalog),
            (self.schema, schema),
            (self.table, table),
        ):
            if pattern is not None and not re.fullmatch(pattern, value):
                return False
        return True


class RuleBasedAccessControl(AccessControl):
    """First matching rule wins; no matching rule denies (the file-based
    plugin's semantics once any table rules are configured)."""

    def __init__(self, rules: Sequence[TableRule]):
        self._rules = list(rules)
        # dynamic grants (GrantTask/RevokeTask analogue): privileges union
        # with the static config rules
        self._grants: Dict[Tuple[str, str, str, str], set] = {}

    @staticmethod
    def from_config(config: dict) -> "RuleBasedAccessControl":
        """{"tables": [{"user": "...", "catalog": "...", "schema": "...",
        "table": "...", "privileges": ["SELECT", ...]}]}"""
        rules = [
            TableRule(
                user=r.get("user"),
                catalog=r.get("catalog"),
                schema=r.get("schema"),
                table=r.get("table"),
                privileges=tuple(p.upper() for p in r.get("privileges", ())),
            )
            for r in config.get("tables", ())
        ]
        return RuleBasedAccessControl(rules)

    def _privileges(self, user: str, catalog: str, schema: str, table: str) -> Tuple[str, ...]:
        granted = self._grants.get((user, catalog, schema, table), set())
        for rule in self._rules:
            if rule.matches(user, catalog, schema, table):
                return tuple(set(rule.privileges) | granted)
        return tuple(granted)

    def grant(self, granter, privileges, catalog, schema, table, grantee):
        """GRANT requires the granter to hold OWNERSHIP on the table (the
        reference's checkCanGrantTablePrivilege ownership rule)."""
        if "OWNERSHIP" not in self._privileges(granter, catalog, schema, table):
            raise AccessDeniedError(
                f"Cannot grant privileges on table {catalog}.{schema}.{table} "
                f"as user {granter}"
            )
        key = (grantee, catalog, schema, table)
        self._grants.setdefault(key, set()).update(p.upper() for p in privileges)

    def revoke(self, granter, privileges, catalog, schema, table, grantee):
        if "OWNERSHIP" not in self._privileges(granter, catalog, schema, table):
            raise AccessDeniedError(
                f"Cannot revoke privileges on table {catalog}.{schema}.{table} "
                f"as user {granter}"
            )
        key = (grantee, catalog, schema, table)
        if key in self._grants:
            self._grants[key] -= {p.upper() for p in privileges}

    def _check(self, privilege: str, user: str, catalog: str, schema: str, table: str) -> None:
        granted = self._privileges(user, catalog, schema, table)
        if privilege not in granted and "OWNERSHIP" not in granted:
            raise AccessDeniedError(
                f"Cannot {privilege.lower()} from/into table "
                f"{catalog}.{schema}.{table} as user {user}"
            )

    def check_can_select(self, user, catalog, schema, table, columns=()):
        self._check("SELECT", user, catalog, schema, table)

    def check_can_insert(self, user, catalog, schema, table):
        self._check("INSERT", user, catalog, schema, table)

    def check_can_delete(self, user, catalog, schema, table):
        self._check("DELETE", user, catalog, schema, table)

    def check_can_update(self, user, catalog, schema, table):
        self._check("UPDATE", user, catalog, schema, table)

    def check_can_create_table(self, user, catalog, schema, table):
        self._check("OWNERSHIP", user, catalog, schema, table)

    def check_can_drop_table(self, user, catalog, schema, table):
        self._check("OWNERSHIP", user, catalog, schema, table)

    def check_can_create_view(self, user, catalog, schema, view):
        self._check("OWNERSHIP", user, catalog, schema, view)

    def check_can_drop_view(self, user, catalog, schema, view):
        self._check("OWNERSHIP", user, catalog, schema, view)

    def filter_catalogs(self, user, catalogs):
        out = []
        for c in catalogs:
            if any(
                r.privileges
                and (r.user is None or re.fullmatch(r.user, user))
                and (r.catalog is None or re.fullmatch(r.catalog, c))
                for r in self._rules
            ):
                out.append(c)
        return out

    def filter_tables(self, user, catalog, tables):
        return [
            st
            for st in tables
            if self._privileges(user, catalog, st.schema, st.table)
        ]

    def filter_schemas(self, user, catalog, schemas):
        # a schema is visible when some table in it could be granted access:
        # walk rules in order — a whole-schema deny (table pattern None, no
        # privileges) hides it; ANY matching grant rule (even table-scoped)
        # shows it; table-scoped denies only shadow their own tables and are
        # skipped here (filter_tables handles them per table)
        out = []
        for s in schemas:
            for r in self._rules:
                if (
                    (r.user is None or re.fullmatch(r.user, user))
                    and (r.catalog is None or re.fullmatch(r.catalog, catalog))
                    and (r.schema is None or re.fullmatch(r.schema, s))
                ):
                    if r.privileges:
                        out.append(s)
                        break
                    if r.table is None:  # whole-schema deny
                        break
        return out


# --------------------------------------------------------------------------- #
# authentication
# --------------------------------------------------------------------------- #


_PBKDF2_ITERATIONS = 100_000


@dataclass
class PasswordAuthenticator:
    """user -> salted PBKDF2-HMAC-SHA256 records (file authenticator analogue;
    the reference's file-based provider stores bcrypt/PBKDF2, never plain
    digests — password-file.md). Record format:
    ``pbkdf2:<iterations>:<salt-hex>:<derived-key-hex>``."""

    users: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def from_lines(lines: Iterable[str]) -> "PasswordAuthenticator":
        """Lines of ``user:pbkdf2:<iters>:<salt>:<dk>`` (comments/blanks
        skipped). Rejects unrecognized record formats at LOAD time — a legacy
        plain-digest file would otherwise load fine and then fail every
        login with a generic credentials error."""
        users = {}
        for i, line in enumerate(lines, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            user, _, record = line.partition(":")
            if not record.startswith("pbkdf2:"):
                raise ValueError(
                    f"password file line {i}: unsupported record format for "
                    f"user {user!r} (expected pbkdf2:<iters>:<salt>:<dk>; "
                    f"re-hash with PasswordAuthenticator.hash_password)"
                )
            users[user] = record.lower()
        return PasswordAuthenticator(users)

    @staticmethod
    def hash_password(password: str, salt: Optional[bytes] = None) -> str:
        if salt is None:
            salt = os.urandom(16)
        dk = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt, _PBKDF2_ITERATIONS
        )
        return f"pbkdf2:{_PBKDF2_ITERATIONS}:{salt.hex()}:{dk.hex()}"

    def add_user(self, user: str, password: str) -> None:
        self.users[user] = self.hash_password(password)

    def authenticate(self, user: str, password: str) -> None:
        record = self.users.get(user)
        ok = False
        if record is not None:
            try:
                _, iters, salt_hex, dk_hex = record.split(":")
                salt, iters = bytes.fromhex(salt_hex), int(iters)
            except ValueError:
                # malformed record: burn the same work as a real check so a
                # timing attacker can't distinguish it from an unknown user
                salt, iters, dk_hex = b"\0" * 16, _PBKDF2_ITERATIONS, ""
            dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iters)
            ok = hmac.compare_digest(dk.hex(), dk_hex)
        else:
            # burn comparable work for unknown users — no timing oracle on
            # username existence
            hashlib.pbkdf2_hmac(
                "sha256", password.encode(), b"\0" * 16, _PBKDF2_ITERATIONS
            )
        if not ok:
            raise AuthenticationError(f"invalid credentials for user {user!r}")


@dataclass
class JwtAuthenticator:
    """HS256 JWT bearer-token authenticator (ref: server/security/jwt/
    JwtAuthenticator.java — the reference validates RS/ES/HS families against
    a key file or JWKS endpoint; the shared-secret HS256 slice covers the
    stdlib-only deployment). Validates the signature, ``exp``/``nbf`` windows,
    and optional ``iss``/``aud`` claims; the principal comes from
    ``principal_claim`` (default ``sub``, the reference's principal-field)."""

    secret: bytes
    issuer: Optional[str] = None
    audience: Optional[str] = None
    principal_claim: str = "sub"
    leeway_secs: int = 30

    @staticmethod
    def _b64url_decode(part: str) -> bytes:
        pad = "=" * (-len(part) % 4)
        import base64

        return base64.urlsafe_b64decode(part + pad)

    @staticmethod
    def _b64url_encode(raw: bytes) -> str:
        import base64

        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    def issue(self, user: str, ttl_secs: int = 3600, **claims) -> str:
        """Mint a token (test/ops helper — the reference leaves issuance to
        the IdP; HS256 makes the verifier a natural issuer too)."""
        import json
        import time

        header = {"alg": "HS256", "typ": "JWT"}
        payload = {self.principal_claim: user, "exp": int(time.time()) + ttl_secs}
        if self.issuer:
            payload["iss"] = self.issuer
        if self.audience:
            payload["aud"] = self.audience
        payload.update(claims)
        h = self._b64url_encode(json.dumps(header, separators=(",", ":")).encode())
        p = self._b64url_encode(json.dumps(payload, separators=(",", ":")).encode())
        sig = hmac.new(self.secret, f"{h}.{p}".encode(), hashlib.sha256).digest()
        return f"{h}.{p}.{self._b64url_encode(sig)}"

    def authenticate_token(self, token: str) -> str:
        """Validated principal for a bearer token, or AuthenticationError."""
        import json
        import time

        try:
            h_part, p_part, s_part = token.split(".")
            header = json.loads(self._b64url_decode(h_part))
            payload = json.loads(self._b64url_decode(p_part))
            signature = self._b64url_decode(s_part)
        except Exception:
            raise AuthenticationError("malformed JWT") from None
        if header.get("alg") != "HS256":
            # never accept alg=none or an unexpected family (classic JWT
            # confusion attack; the reference pins algorithms per key type)
            raise AuthenticationError(f"unsupported JWT alg {header.get('alg')!r}")
        want = hmac.new(
            self.secret, f"{h_part}.{p_part}".encode(), hashlib.sha256
        ).digest()
        if not hmac.compare_digest(signature, want):
            raise AuthenticationError("invalid JWT signature")
        now = time.time()
        exp = payload.get("exp")
        if exp is not None and now > float(exp) + self.leeway_secs:
            raise AuthenticationError("JWT expired")
        nbf = payload.get("nbf")
        if nbf is not None and now < float(nbf) - self.leeway_secs:
            raise AuthenticationError("JWT not yet valid")
        if self.issuer is not None and payload.get("iss") != self.issuer:
            raise AuthenticationError("JWT issuer mismatch")
        if self.audience is not None:
            aud = payload.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise AuthenticationError("JWT audience mismatch")
        principal = payload.get(self.principal_claim)
        if not principal:
            raise AuthenticationError(
                f"JWT missing principal claim {self.principal_claim!r}"
            )
        return str(principal)


@dataclass
class OAuth2Authenticator:
    """OAuth2 authorization-code flow + bearer-token validation (ref:
    server/security/oauth2/OAuth2Authenticator.java:40, OAuth2Service +
    NimbusAirliftHttpClient's code exchange).

    Two roles, like the reference:
    - the WEB flow: ``authorization_url`` sends the browser to the IdP;
      ``exchange_code`` posts the returned code to the IdP's token endpoint
      and yields the access token.
    - the API path: ``authenticate_token`` validates presented Bearer
      tokens (HS256 shared-secret JWTs with iss/aud/exp checks — the
      JWKS/RS256 family needs an RSA dependency this image lacks; the
      validation CONTRACT is the same).

    ``state`` is HMAC-signed with the client secret AND timestamped: the
    callback rejects forged states outright and expired ones after
    ``state_ttl_secs`` (the reference's OAuth2TokenExchange state-key hmac +
    challenge timeout). States are not single-use — replay within the TTL
    only restarts a login, never mints a token without the IdP's code."""

    issuer: str
    client_id: str
    client_secret: str
    authorize_url: str
    token_url: str
    shared_secret: str
    audience: Optional[str] = None
    principal_claim: str = "sub"
    state_ttl_secs: int = 600

    def _jwt(self) -> "JwtAuthenticator":
        return JwtAuthenticator(
            secret=self.shared_secret.encode(),
            issuer=self.issuer,
            audience=self.audience,
            principal_claim=self.principal_claim,
        )

    # ------------------------------------------------------------- web flow

    def sign_state(self, nonce: str) -> str:
        import time

        ts = str(int(time.time()))
        mac = hmac.new(
            self.client_secret.encode(),
            f"state:{nonce}:{ts}".encode(),
            hashlib.sha256,
        ).hexdigest()
        return f"{nonce}.{ts}.{mac}"

    def check_state(self, state: str) -> bool:
        import time

        parts = state.split(".")
        if len(parts) != 3:
            return False
        nonce, ts, mac = parts
        want = hmac.new(
            self.client_secret.encode(),
            f"state:{nonce}:{ts}".encode(),
            hashlib.sha256,
        ).hexdigest()
        if not hmac.compare_digest(mac, want):
            return False
        try:
            age = time.time() - int(ts)
        except ValueError:
            return False
        return 0 <= age <= self.state_ttl_secs

    def authorization_url(self, redirect_uri: str, state: str) -> str:
        from urllib.parse import urlencode

        return self.authorize_url + "?" + urlencode(
            {
                "response_type": "code",
                "client_id": self.client_id,
                "redirect_uri": redirect_uri,
                "state": state,
                "scope": "openid",
            }
        )

    def exchange_code(self, code: str, redirect_uri: str) -> str:
        """code -> access token via the IdP token endpoint (authorization_code
        grant, client-secret-post authentication)."""
        import json as _json
        import urllib.request
        from urllib.parse import urlencode

        body = urlencode(
            {
                "grant_type": "authorization_code",
                "code": code,
                "redirect_uri": redirect_uri,
                "client_id": self.client_id,
                "client_secret": self.client_secret,
            }
        ).encode()
        req = urllib.request.Request(
            self.token_url,
            data=body,
            headers={"Content-Type": "application/x-www-form-urlencoded"},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            payload = _json.loads(resp.read())
        token = payload.get("access_token")
        if not token:
            raise AuthenticationError("IdP token response missing access_token")
        # validate BEFORE accepting: a hostile IdP response must not mint a
        # session (the reference validates the ID token's signature + claims)
        self.authenticate_token(token)
        return token

    # ------------------------------------------------------------- api path

    def authenticate_token(self, token: str) -> str:
        return self._jwt().authenticate_token(token)
