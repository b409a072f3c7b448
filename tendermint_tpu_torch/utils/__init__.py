"""Host-side helpers of the verify spine: backoff, circuit breaker,
device fault injection, structured logging and lock construction."""
