"""Seconds of audio returned to the client, cropped to the true lengths,
over the seconds of the whole window (first call's start to last call's
end)."""


def read(run):
    if "records" not in run:
        return None
    audio = sum(r["audio_s"] for r in run["records"])
    return audio / run["seconds"]
