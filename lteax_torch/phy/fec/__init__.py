"""36.212 FEC: CRC, rate-match plans, turbo code tables and decoder driver."""
