"""FDSN data acquisition: the reference's station/catalog download path
(``make_initial_files.py:12-23`` ``setup_region``/obspy ``get_stations``;
``utils.py:1095-1116`` ``download_catalog``) behind an import guard.

Port of ``genie_tpu/setup/fdsn.py`` (host code, a copy). obspy is imported
inside each function, with an actionable error where it is missing.
Everything downstream (``init_project``, catalog conversion) takes plain
arrays, so these helpers are the port's only obspy touchpoint.
"""

from __future__ import annotations

import numpy as np

_OBSPY_HINT = ("FDSN acquisition requires obspy (`pip install obspy`); "
               "offline, pass station/catalog arrays or txt files instead "
               "(see genie_tpu_torch.setup.project.init_project)")


def _fdsn_client(client):
    try:
        from obspy.clients.fdsn import Client
    except ImportError as e:
        raise ImportError(_OBSPY_HINT) from e
    return Client(client) if isinstance(client, str) else client


def _utc(t):
    from obspy.core import UTCDateTime
    return t if isinstance(t, UTCDateTime) else UTCDateTime(t)


def download_stations(lat_range, lon_range, starttime, endtime,
                      network="*", station="*", client="NCEDC"):
    """Station inventory for a region → ``(sta_lla (n,3), names (n,))``
    sorted by latitude, matching the reference's ``setup_region`` +
    ``extract_station_data`` (make_initial_files.py:12-34)."""
    cl = _fdsn_client(client)
    inv = cl.get_stations(
        starttime=_utc(starttime), endtime=_utc(endtime),
        network=network, station=station,
        minlatitude=lat_range[0], maxlatitude=lat_range[1],
        minlongitude=lon_range[0], maxlongitude=lon_range[1])
    names, rows = [], []
    for net in inv:
        for sta in net:
            names.append(sta.code)
            rows.append([sta.latitude, sta.longitude, sta.elevation])
    if not rows:
        return np.zeros((0, 3)), np.asarray([], dtype=object)
    lla = np.asarray(rows, np.float64)
    names = np.asarray(names)
    order = np.argsort(lla[:, 0])
    return lla[order], names[order]


def download_catalog(lat_range, lon_range, min_magnitude, starttime, endtime,
                     t0=None, client="NCEDC", include_arrivals=False):
    """Regional event catalog → ``(cat (n,5) [lat, lon, -depth_m, t_rel_s,
    mag], events, event_types)``: the reference's ``download_catalog``
    contract (utils.py:1095-1116), times relative to ``t0`` (default
    2000-01-01)."""
    cl = _fdsn_client(client)
    from obspy.core import UTCDateTime
    t0 = UTCDateTime(2000, 1, 1) if t0 is None else _utc(t0)
    events = cl.get_events(
        starttime=_utc(starttime), endtime=_utc(endtime),
        minlatitude=lat_range[0], maxlatitude=lat_range[1],
        minlongitude=lon_range[0], maxlongitude=lon_range[1],
        minmagnitude=min_magnitude, includearrivals=include_arrivals,
        orderby="time-asc")
    rows, types = [], []
    for ev in events:
        o = ev.origins[0]
        mag = ev.magnitudes[0].mag if ev.magnitudes else np.nan
        rows.append([o.latitude, o.longitude, -1.0 * o.depth,
                     float(o.time - t0), mag])
        types.append(ev.event_type)
    cat = (np.asarray(rows, np.float64) if rows
           else np.zeros((0, 5), np.float64))
    return cat, events, np.asarray(types, dtype=object)
