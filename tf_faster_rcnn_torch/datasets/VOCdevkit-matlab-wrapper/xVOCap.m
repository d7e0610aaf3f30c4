function ap = xVOCap(rec, prec)
% Area-under-curve AP (the VOC 2010+ metric): precision envelope over the
% recall axis, summed where recall changes.

mrec = [0; rec; 1];
mpre = [0; prec; 0];
for i = numel(mpre) - 1 : -1 : 1
  mpre(i) = max(mpre(i), mpre(i + 1));
end
i = find(mrec(2:end) ~= mrec(1:end-1)) + 1;
ap = sum((mrec(i) - mrec(i - 1)) .* mpre(i));

end
