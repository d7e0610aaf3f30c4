function results = voc_eval(devkit_path, comp_id, test_set, output_dir)
% Official-VOCdevkit evaluation driver (optional; fills the role of the
% reference's MATLAB wrapper). Invoked by pascal_voc._do_matlab_eval when
% cfg.MATLAB points at a MATLAB binary and matlab_eval is enabled.
% Requires the VOCdevkit VOCcode on the path at <devkit_path>/VOCcode.

opts = get_voc_opts(devkit_path);
opts.testset = test_set;
addpath(fullfile(opts.datadir, 'VOCcode'));

n = length(opts.classes);
results = struct('recall', cell(1, n), 'prec', cell(1, n), ...
                 'ap', cell(1, n), 'ap_auc', cell(1, n));
for k = 1:n
  results(k) = eval_one_class(opts.classes{k}, opts, comp_id, output_dir);
end

all_ap = [results(:).ap]';
fprintf('\n~~~~~~~~~~~~~~~~~~~~\n');
fprintf('Results (MATLAB eval):\n');
fprintf('%.1f\n', all_ap * 100);
fprintf('%.1f\n', mean(all_ap) * 100);
fprintf('~~~~~~~~~~~~~~~~~~~~\n');

end

function out = eval_one_class(cls, opts, comp_id, output_dir)
% One class through VOCevaldet; 11-point AP plus the AUC variant.
% Ground truth is only available for <=2007 test sets and non-test splits,
% so later test sets skip scoring (results go to the eval server instead).

out = struct('recall', [], 'prec', [], 'ap', 0, 'ap_auc', 0);
year_num = str2num(opts.dataset(4:end));  %#ok<ST2NM>
scoreable = (year_num <= 2007) || ~strcmp(opts.testset, 'test');
if scoreable
  tic;
  [out.recall, out.prec, out.ap] = VOCevaldet(opts, comp_id, cls, true);
  out.ap_auc = xVOCap(out.recall, out.prec);
  fprintf('!!! %s : %.4f %.4f\n', cls, out.ap, out.ap_auc);
end

res = out;  % legacy field name kept in the .mat for downstream readers
recall = out.recall; prec = out.prec; ap = out.ap; ap_auc = out.ap_auc;
save([output_dir '/' cls '_pr.mat'], ...
     'res', 'recall', 'prec', 'ap', 'ap_auc');

end
