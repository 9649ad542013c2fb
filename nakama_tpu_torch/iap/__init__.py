"""In-app-purchase receipt validation clients (reference iap/iap.go);
the port's copy of the JAX package's `iap/`."""

from .client import (
    ENV_PRODUCTION,
    ENV_SANDBOX,
    STORE_APPLE,
    STORE_GOOGLE,
    STORE_HUAWEI,
    IAPError,
    ValidatedPurchase,
    google_access_token,
    validate_receipt_apple,
    validate_receipt_google,
    validate_subscription_apple,
    validate_subscription_google,
    validate_receipt_huawei,
)
from .refund import GoogleRefundScheduler

__all__ = [
    "GoogleRefundScheduler",
    "google_access_token",
    "ENV_PRODUCTION",
    "ENV_SANDBOX",
    "IAPError",
    "STORE_APPLE",
    "STORE_GOOGLE",
    "STORE_HUAWEI",
    "ValidatedPurchase",
    "validate_receipt_apple",
    "validate_receipt_google",
    "validate_subscription_apple",
    "validate_subscription_google",
    "validate_receipt_huawei",
]
