"""UPnP IGD port mapping (reference `p2p/upnp/` Discover/Probe).

NAT traversal for home nodes: SSDP multicast discovery of an Internet
Gateway Device, then SOAP calls for GetExternalIPAddress /
AddPortMapping / DeletePortMapping. Pure stdlib (socket + HTTP).
`probe` mirrors the reference's `probe_upnp` CLI flow: discover, map a
port, report the external address, clean up.
"""

from __future__ import annotations

import re
import socket
import urllib.error
import urllib.request
from dataclasses import dataclass

SSDP_ADDR = ("239.255.255.250", 1900)
_SEARCH = (
    "M-SEARCH * HTTP/1.1\r\n"
    f"HOST: {SSDP_ADDR[0]}:{SSDP_ADDR[1]}\r\n"
    'MAN: "ssdp:discover"\r\n'
    "MX: 2\r\n"
    "ST: urn:schemas-upnp-org:device:InternetGatewayDevice:1\r\n\r\n"
)
_WAN_SERVICES = (
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)


class UPnPError(Exception):
    pass


@dataclass
class Gateway:
    control_url: str
    service_type: str
    local_ip: str


def _soap(control_url: str, service: str, action: str, args: dict, timeout: float = 5.0) -> str:
    body = (
        '<?xml version="1.0"?>'
        '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/" '
        's:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
        f'<s:Body><u:{action} xmlns:u="{service}">'
        + "".join(f"<{k}>{v}</{k}>" for k, v in args.items())
        + f"</u:{action}></s:Body></s:Envelope>"
    ).encode()
    req = urllib.request.Request(
        control_url,
        data=body,
        headers={
            "Content-Type": 'text/xml; charset="utf-8"',
            "SOAPAction": f'"{service}#{action}"',
        },
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode(errors="replace")
    except (OSError, urllib.error.URLError) as e:
        # SOAP faults arrive as HTTP 500 (e.g. ConflictInMappingEntry)
        raise UPnPError(f"{action} failed: {e}") from e


def discover(timeout: float = 3.0, ssdp_addr=None) -> Gateway:
    """SSDP M-SEARCH for an IGD; fetch its description; find the WAN
    service control URL (reference `upnp.Discover`)."""
    addr = ssdp_addr or SSDP_ADDR
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        sock.sendto(_SEARCH.encode(), addr)
        data, server = sock.recvfrom(4096)
        local_ip = sock.getsockname()[0]
    except socket.timeout as e:
        raise UPnPError("no UPnP gateway responded") from e
    finally:
        sock.close()
    m = re.search(rb"(?im)^location:\s*(\S+)", data)
    if not m:
        raise UPnPError("SSDP response missing LOCATION")
    location = m.group(1).decode()
    try:
        with urllib.request.urlopen(location, timeout=timeout) as resp:
            desc = resp.read().decode(errors="replace")
    except (OSError, urllib.error.URLError) as e:
        raise UPnPError(f"gateway description fetch failed: {e}") from e
    for service in _WAN_SERVICES:
        pattern = (
            re.escape(service)
            + r".*?<controlURL>([^<]+)</controlURL>"
        )
        sm = re.search(pattern, desc, re.S)
        if sm:
            control = sm.group(1)
            if control.startswith("/"):
                base = location.split("/", 3)
                control = f"{base[0]}//{base[2]}{control}"
            if local_ip in ("0.0.0.0", ""):
                # learn our LAN-facing address by routing toward the gw
                probe_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:
                    probe_sock.connect((server[0], 80))
                    local_ip = probe_sock.getsockname()[0]
                finally:
                    probe_sock.close()
            return Gateway(control, service, local_ip)
    raise UPnPError("gateway exposes no WAN connection service")


def external_ip(gw: Gateway) -> str:
    resp = _soap(gw.control_url, gw.service_type, "GetExternalIPAddress", {})
    m = re.search(r"<NewExternalIPAddress>([^<]*)</NewExternalIPAddress>", resp)
    if not m:
        raise UPnPError("no external IP in response")
    return m.group(1)


def add_port_mapping(
    gw: Gateway, external_port: int, internal_port: int, description: str = "tendermint_tpu", lease_s: int = 0
) -> None:
    _soap(
        gw.control_url,
        gw.service_type,
        "AddPortMapping",
        {
            "NewRemoteHost": "",
            "NewExternalPort": external_port,
            "NewProtocol": "TCP",
            "NewInternalPort": internal_port,
            "NewInternalClient": gw.local_ip,
            "NewEnabled": 1,
            "NewPortMappingDescription": description,
            "NewLeaseDuration": lease_s,
        },
    )


def delete_port_mapping(gw: Gateway, external_port: int) -> None:
    _soap(
        gw.control_url,
        gw.service_type,
        "DeletePortMapping",
        {"NewRemoteHost": "", "NewExternalPort": external_port, "NewProtocol": "TCP"},
    )


def probe(port: int = 46656, ssdp_addr=None) -> dict:
    """Discover, map, verify, unmap (reference `probe_upnp` command)."""
    gw = discover(ssdp_addr=ssdp_addr)
    ip = external_ip(gw)
    add_port_mapping(gw, port, port, description="tendermint_tpu-probe")
    try:
        return {"external_ip": ip, "port": port, "control_url": gw.control_url}
    finally:
        delete_port_mapping(gw, port)
