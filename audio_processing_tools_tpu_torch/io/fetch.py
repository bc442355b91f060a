"""S3 storage plane (gated on boto3; parity with reference ``fetch.py``).

Copy of ``audio_processing_tools_tpu/io/fetch.py`` for the port (the
card's machine has no JAX); boto3 is imported only for a request that
reaches S3, so a fetch served from the local cache needs none.

Device audio lands in two buckets (prod / test) under two key layouts
(``audio/<device>/<loc>/<unix_ts>`` legacy JSON-chunk uploads,
``raw_audio/<device>/.../<date>_rain_xxx`` binary uploads).  The fetch layer
handles per-key bucket fallback, a local file cache, header-only byte-range
reads (bytes 0-39), and a threaded multi-key prefetch pool that feeds the
host decode stage ahead of the copy to the card.
"""

from __future__ import annotations

import datetime as dt
import os
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Optional

PROD_AWS_PROFILE = "arable_prod"
DEFAULT_BUCKETS = ["arable-device-data-test", "arable-device-data"]


def _require_boto3():
    try:
        import boto3  # noqa: F401

        return boto3
    except ImportError as e:
        raise ImportError(
            "boto3 is required for S3 fetch operations but is not installed. "
            "Use InputType='LocalPath' or install boto3."
        ) from e


_default_session = None


def get_prod_boto_session(profile_name: Optional[str] = None,
                          aws_access_key_id: Optional[str] = None,
                          aws_secret_access_key: Optional[str] = None,
                          aws_region: Optional[str] = "us-east-1"):
    """boto3 session with profile/key fallback (``fetch.py:19-49``).

    The default (no-arg) session is memoized so lazy per-key fetches in the
    threaded pool share one session instead of rebuilding credentials.
    """
    global _default_session
    if (profile_name is None and aws_access_key_id is None
            and aws_secret_access_key is None and _default_session is not None):
        return _default_session
    boto3 = _require_boto3()
    from botocore.exceptions import NoCredentialsError, ProfileNotFound

    def _memo(sess):
        global _default_session
        if (profile_name is None and aws_access_key_id is None
                and aws_secret_access_key is None):
            _default_session = sess
        return sess

    try:
        if aws_access_key_id and aws_secret_access_key:
            return boto3.session.Session(
                aws_access_key_id=aws_access_key_id,
                aws_secret_access_key=aws_secret_access_key,
                region_name=aws_region,
            )
        if profile_name:
            return boto3.session.Session(profile_name=profile_name)
        return _memo(boto3.session.Session(profile_name=PROD_AWS_PROFILE))
    except (ProfileNotFound, NoCredentialsError):
        print("WARNING: Could not find AWS credentials. Using default session.")
        return _memo(boto3.session.Session())


def fetch_raw_audio_from_s3(key_to_fetch: str, bucket: str, boto_session=None,
                            header_only: bool = False) -> bytes:
    """Single-object fetch; ``header_only`` uses a bytes=0-39 Range read."""
    if boto_session is None:
        boto_session = get_prod_boto_session()
    s3 = boto_session.client("s3")
    if header_only:
        resp = s3.get_object(Bucket=bucket, Key=key_to_fetch, Range="bytes=0-39")
    else:
        resp = s3.get_object(Bucket=bucket, Key=key_to_fetch)
    return resp["Body"].read()


def get_raw_audio_data(file_key: str, bucket: str, boto_session=None,
                       local_cache_location: str = "raw_audio_cache",
                       redownload: bool = False, use_caching: bool = True,
                       header_only: bool = False) -> bytes:
    """Cached single-key fetch (``fetch.py:91-142``)."""
    if use_caching:
        local_path = os.path.join(local_cache_location or "raw_audio_cache", file_key)
        if os.path.isfile(local_path) and not redownload:
            with open(local_path, "rb") as f:
                return f.read()
        content = fetch_raw_audio_from_s3(file_key, bucket, boto_session, header_only)
        os.makedirs(os.path.dirname(local_path), exist_ok=True)
        with open(local_path, "wb") as f:
            f.write(content)
        return content
    return fetch_raw_audio_from_s3(file_key, bucket, boto_session, header_only)


def list_audio_keys(prefix: str, bucket: str, boto_session=None) -> List[str]:
    if boto_session is None:
        boto_session = get_prod_boto_session()
    bucket_resource = boto_session.resource("s3").Bucket(bucket)
    return [obj.key for obj in bucket_resource.objects.filter(Prefix=prefix)]


def get_device_audio_keys(device: str, start_date: dt.datetime,
                          end_date: dt.datetime, bucket: str,
                          parent_folder: str, boto_session=None) -> List[str]:
    """Keys for a device within a date range, both key layouts
    (``fetch.py:172-226``)."""
    all_keys = list_audio_keys(f"{parent_folder}/{device}/", bucket, boto_session)
    if parent_folder == "audio":
        by_date = {
            dt.datetime.fromtimestamp(int(p.split("/")[-1])): p for p in all_keys
        }
    elif parent_folder == "raw_audio":
        fmt = "%Y%m%d_%H_%M_%S_000000"
        by_date = {
            dt.datetime.strptime(p.split("/")[-1].split("_rain_")[0], fmt): p
            for p in all_keys
        }
    else:
        raise ValueError(
            f"Did not recognize parent folder: '{parent_folder}'. "
            "Expected 'audio' or 'raw_audio'."
        )
    return [k for d, k in by_date.items() if end_date >= d >= start_date]


def get_device_raw_audio_data(device: Optional[str] = None,
                              start_date: Optional[dt.datetime] = None,
                              end_date: Optional[dt.datetime] = None,
                              boto_session=None,
                              local_cache_location: str = "raw_audio_cache",
                              redownload: bool = False, use_caching: bool = True,
                              header_only: bool = False,
                              keys: Optional[List[str]] = None,
                              verbose: bool = False, max_threads: int = 10,
                              show_progress: bool = False,
                              buckets: Optional[List[str]] = None
                              ) -> Dict[str, bytes]:
    """Threaded multi-key fetch with per-key bucket fallback
    (``fetch.py:229-353``).  Returns {key: bytes}.

    The boto session is created lazily on the first actual S3 request, so
    fully-cached fetches work on hosts without boto3/credentials.
    """
    if keys is None and (start_date is None or end_date is None or device is None):
        raise ValueError(
            "Must provide start_date + end_date + device OR a list of keys"
        )
    buckets = buckets or DEFAULT_BUCKETS
    out: Dict[str, bytes] = {}

    def fetch_one(key):
        for bucket in buckets:
            try:
                result = get_raw_audio_data(
                    key, bucket, boto_session=boto_session,
                    local_cache_location=local_cache_location,
                    redownload=redownload, use_caching=use_caching,
                    header_only=header_only,
                )
                if result:
                    return key, result
            except Exception as e:
                if verbose:
                    print(f"Error retrieving key {key} from bucket {bucket}: {e}")
        return key, None

    def process(key_list):
        with ThreadPoolExecutor(max_workers=max_threads) as ex:
            futures = [ex.submit(fetch_one, k) for k in key_list]
            it = as_completed(futures)
            if show_progress:
                try:
                    from tqdm import tqdm

                    it = tqdm(it, total=len(key_list), desc="Fetching", unit="file")
                except ImportError:
                    pass
            for fut in it:
                key, result = fut.result()
                if result:
                    out[key] = result

    if keys is not None:
        process(keys)
    else:
        for bucket in buckets:
            folders = ["raw_audio"] if header_only else ["audio", "raw_audio"]
            for folder in folders:
                ks = get_device_audio_keys(
                    device, start_date, end_date, bucket, folder, boto_session
                )
                if ks:
                    process(ks)
    return out
